"""The port's two-stage vote ingest (consensus/ingest.py in front of
consensus/state.py) against the JAX package's, on the CPU.

One parked observer node of 16 validators (bench.py's consensus-ingest
shape: no private validator, a one-hour propose timeout, every tally kept
below 2/3) in each package takes the same seeded votes — 2 waves of
`testing.make_vote_waves`, fed by 4 peers, with gossip duplicates, a
malformed vote and a tampered signature mixed in — through the sequential
facade, the pipeline inside a running VerifyHub, and the pipeline with no
hub. Both packages tally the same votes, apply them in the same order with
the same stage-1 verdicts, count the same ingest stats and call
`invalid_sig_hook` for the same peer and vote. The tolerance is zero.

The port's own cases: stage 1 reaching the plain `kernel_eq` once the
cutoff is lowered to 8, and a device error in the hub, which is counted in
`hub_errors` (never in `unverified`) and never re-verified on the host.
"""

from __future__ import annotations

import asyncio
import shutil
import time
import types

import pytest

import tendermint_tpu.consensus.harness as j_harness
import tendermint_tpu.consensus.types as j_ctypes
import tendermint_tpu.crypto.verify_hub as j_vh
import tendermint_tpu.types.vote as j_vote
import tendermint_tpu_torch.consensus.harness as p_harness
import tendermint_tpu_torch.consensus.types as p_ctypes
import tendermint_tpu_torch.crypto.verify_hub as p_vh
import tendermint_tpu_torch.testing as p_tt
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
from tendermint_tpu_torch.types.vote import Vote

N_VALS, WAVES, PEERS = 16, 2, 4
STATS = ("submitted", "released", "dedup_drops", "structural_drops", "pre_verified",
         "sig_invalid", "unverified")

REF = types.SimpleNamespace(harness=j_harness, ctypes=j_ctypes, vh=j_vh, kw={},
                            hub_kw={}, vote=lambda v: convert.to_reference(v, j_vote.Vote))
PORT = types.SimpleNamespace(harness=p_harness, ctypes=p_ctypes, vh=p_vh, kw={"device": "cpu"},
                             hub_kw={"device": "cpu"}, vote=lambda v: v)


def _config(pkg, pipeline: bool, inflight: int = 256):
    cfg = pkg.harness.fast_config()
    cfg.ingest_pipeline = pipeline
    cfg.ingest_max_inflight = inflight
    cfg.timeout_propose_ns = 3_600 * 10**9  # park the observer: tally, never drive rounds
    cfg.timeout_commit_ns = 0
    return cfg


def _feed():
    """The port's votes for both packages: 2 waves of 32, each with one
    malformed vote (no signature) and then, after the wave, a re-gossip
    of its first 3 votes (duplicates); in wave 0, a flipped signature
    bit on validator 5's round-1 prevote."""
    genesis, keys = p_harness.make_genesis(N_VALS)
    vals = p_harness.state_from_genesis(genesis).validators
    waves = p_tt.make_vote_waves(genesis.chain_id, vals, keys, 1, WAVES)
    out = []
    for w, votes in enumerate(waves):
        votes = list(votes)
        if w == 0:
            i = next(k for k, v in enumerate(votes) if v.round == 1 and v.validator_index == 5)
            sig = votes[i].signature
            votes[i] = Vote(**{**votes[i].__dict__,
                                    "signature": bytes([sig[0] ^ 1]) + sig[1:]})
        votes.append(Vote(**{**votes[7].__dict__, "signature": b""}))
        out.append((votes, votes[:3]))
    return out


async def _drain(cs, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cs.msg_queue.empty() and (cs.ingest is None or cs.ingest.inflight == 0):
            await asyncio.sleep(0.05)  # one more beat for the apply
            if cs.msg_queue.empty() and (cs.ingest is None or cs.ingest.inflight == 0):
                return
        await asyncio.sleep(0.01)
    raise TimeoutError("ingest did not drain")


def _tally(cs) -> list:
    out = []
    for r in range(2):
        for vs in (cs.rs.votes.prevotes(r), cs.rs.votes.precommits(r)):
            out.append([(v.validator_index, v.signature) if v else None for v in vs.votes])
    return out


async def _observe(pkg, waves, *, pipeline: bool, hub: bool) -> dict:
    """Feed `waves` to a fresh observer of `pkg`; returns the tallies after
    each wave, the apply order with its stage-1 verdicts, the ingest stats
    and the invalid-signature hook's calls."""
    genesis, _keys = pkg.harness.make_genesis(N_VALS)
    node = pkg.harness.Node(genesis, None, config=_config(pkg, pipeline), **pkg.kw)
    if hub:
        pkg.vh.acquire_hub(max_batch=16, window_ms=1.0, cache_size=0, **pkg.hub_kw)
    applied, bad_sigs, tallies = [], [], []
    try:
        await node.start()
        cs = node.cs
        handle = cs._handle_msg

        def record(mi):
            v = mi.msg.vote
            applied.append((v.validator_index, v.round, int(v.type), v.timestamp_ns,
                            mi.sig_ok, mi.peer_id))
            return handle(mi)

        cs._handle_msg = record
        cs.invalid_sig_hook = lambda peer, v: bad_sigs.append((peer, v.encode()))
        vals = cs.rs.validators
        for votes, dups in waves:
            for batch_ in (votes, dups):
                async def peer(p, batch_=batch_):
                    for v in batch_[p::PEERS]:
                        await cs.add_vote(pkg.vote(v), f"peer{p}")

                await asyncio.gather(*(peer(p) for p in range(PEERS)))
                await _drain(cs)
            tallies.append(_tally(cs))
            cs.rs.votes = pkg.ctypes.HeightVoteSet(cs.state.chain_id, cs.rs.height, vals)
        stats = {k: cs.ingest.stats[k] for k in STATS} if cs.ingest else None
    finally:
        await node.stop()
        if hub:
            pkg.vh.release_hub()
        shutil.rmtree(node.wal_dir, ignore_errors=True)
    return {"tallies": tallies, "applied": applied, "stats": stats, "bad_sigs": bad_sigs}


@pytest.mark.parametrize("pipeline, hub", [(False, True), (True, True), (True, False)],
                         ids=["sequential", "pipelined", "pipelined-no-hub"])
def test_ingest_equals_the_reference(pipeline, hub):
    waves = _feed()
    ref = asyncio.run(_observe(REF, waves, pipeline=pipeline, hub=hub))
    port = asyncio.run(_observe(PORT, waves, pipeline=pipeline, hub=hub))
    assert port == ref
    n_valid = 2 * 32 - 1
    assert sum(x is not None for t in port["tallies"] for vs in t for x in vs) == n_valid
    if pipeline:
        s = port["stats"]
        assert s["submitted"] == 2 * 36 and s["structural_drops"] == 2
        assert s["dedup_drops"] == 6 and s["released"] == 2 * 36 - 8
        if hub:
            assert (s["pre_verified"], s["sig_invalid"], s["unverified"]) == (n_valid, 1, 0)
            # the tampered vote is the one the hook names, with its peer
            assert len(port["bad_sigs"]) == 1 and port["bad_sigs"][0][0] == "peer1"
        else:
            assert (s["pre_verified"], s["sig_invalid"], s["unverified"]) == (0, 0, n_valid + 1)
    # the sequential path drops the bad signature at apply, with no hook call
    if not (pipeline and hub):
        assert port["bad_sigs"] == []


def test_stage_one_reaches_the_plain_kernel_eq_below_a_lowered_cutoff(monkeypatch):
    from tendermint_tpu_torch.crypto.cuda import verify as V

    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 8)
    calls = []
    real = V.kernel_eq

    def kernel_eq(*ops):
        bitmap, eq_ok = real(*ops)
        calls.append((int(bitmap.shape[0]), bool(eq_ok)))
        return bitmap, eq_ok

    monkeypatch.setattr(V, "kernel_eq", kernel_eq)
    waves = [_feed()[1][0][:32]]
    genesis, _keys = p_harness.make_genesis(N_VALS)

    async def run():
        node = p_harness.Node(genesis, None, config=_config(PORT, True), device="cpu")
        hub = p_vh.acquire_hub(device="cpu", max_batch=64, window_ms=200.0, cache_size=0)
        try:
            await node.start()
            cs = node.cs
            await asyncio.gather(*(
                cs.add_vote(v, f"peer{i % PEERS}") for i, v in enumerate(waves[0])))
            await _drain(cs)
            return _tally(cs), dict(cs.ingest.stats), hub.stats()
        finally:
            await node.stop()
            p_vh.release_hub()
            shutil.rmtree(node.wal_dir, ignore_errors=True)

    tally, stats, hs = asyncio.run(run())
    assert calls and all(ok for _n, ok in calls)
    assert stats["pre_verified"] == 32 and stats["unverified"] == 0 and stats["hub_errors"] == 0
    assert sum(x is not None for vs in tally for x in vs) == 32
    assert hs["verify_errors"] == 0


def test_a_device_error_is_counted_apart_and_never_reverified_on_the_host(monkeypatch):
    """The port's difference by design: the reference turns a hub error in
    stage 1 into `unverified` and re-verifies at apply; the port counts it
    in `hub_errors`, and the apply-time check goes back through the hub,
    where the card's error fails the message. The host verifies nothing."""
    host = []
    real_verify = Ed25519PubKey.verify_signature

    def counted(self, msg, sig):
        host.append(msg)
        return real_verify(self, msg, sig)

    monkeypatch.setattr(Ed25519PubKey, "verify_signature", counted)
    votes = _feed()[1][0][:4]
    genesis, _keys = p_harness.make_genesis(N_VALS)

    async def run():
        node = p_harness.Node(genesis, None, config=_config(PORT, True), device="cpu")
        hub = p_vh.acquire_hub(device="cpu", max_batch=16, window_ms=1.0, cache_size=0)

        def fail(batch):
            raise RuntimeError("device error")

        hub._verify_batch = fail
        try:
            await node.start()
            cs = node.cs
            for v in votes:
                await cs.add_vote(v, "peer0")
            await _drain(cs)
            return _tally(cs), dict(cs.ingest.stats), hub.stats()
        finally:
            await node.stop()
            p_vh.release_hub()
            shutil.rmtree(node.wal_dir, ignore_errors=True)

    tally, stats, hs = asyncio.run(run())
    assert stats["hub_errors"] == 4 and stats["unverified"] == 0
    assert stats["pre_verified"] == 0 and stats["released"] == 4
    assert all(x is None for vs in tally for x in vs)  # the apply-time check failed too
    assert hs["verify_errors"] >= 1 + 4  # stage 1, then each apply-time check
    assert host == []
