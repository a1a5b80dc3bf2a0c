"""The port's BootFleet join wave (`testing.statesync_fleet_scenario`) and
poisoned donor (statesync/byzantine.py) against the JAX package's, on
the CPU.

The join wave at a small size (tests/test_boot_fleet.py's two in-process
cases: 3 joiners on a 24-block chain of 4 validators, and a
single-session donor with no chunk cache on 12 blocks): every joiner of
both packages restores the same State and holds the same headers, and
the donor's BootD serves the same chunks from the same store reads and
cache hits. `PoisonedSnapshotApp` poisons the same chunks at the same
byte for the same seed. A joiner offered a poisoned donor and an honest
one bans the poisoned donor and restores the honest State. The port runs
on device="cpu"; the tolerance is zero (bytes, integers)."""

from __future__ import annotations

import asyncio
import types

import pytest
import torch

import tendermint_tpu.abci.types as j_abci
import tendermint_tpu.config as j_config
import tendermint_tpu.statesync.byzantine as j_byz
import tendermint_tpu.statesync.reactor as j_reactor
import tendermint_tpu.testing as j_tt
import tendermint_tpu_torch.abci.types as p_abci
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.statesync.byzantine as p_byz
import tendermint_tpu_torch.statesync.reactor as p_reactor
import tendermint_tpu_torch.testing as p_tt

torch.set_num_threads(1)

REF = types.SimpleNamespace(abci=j_abci, config=j_config, byz=j_byz, reactor=j_reactor,
                            tt=j_tt, kw={})
PORT = types.SimpleNamespace(abci=p_abci, config=p_config, byz=p_byz, reactor=p_reactor,
                             tt=p_tt, kw={"device": "cpu"})
PKGS = (REF, PORT)

# the reference test's two in-process waves: (blocks, validators, joiners,
# backfill blocks, BootDConfig knobs)
WAVES = {
    "three_joiners": (24, 4, 3, 6, {}),
    "single_session_donor": (12, 4, 3, 4, {"max_sessions": 1, "chunk_cache": 0}),
}


def _wave(pkg, case):
    """One join wave; every joiner's restored State is read off its
    reactor's `sync` (the reference's scenario returns none)."""
    n_blocks, n_vals, n_joiners, backfill, knobs = WAVES[case]
    states = []
    real = pkg.reactor.StateSyncReactor.sync

    async def sync(self, cfg):
        state = await real(self, cfg)
        states.append(state.encode())
        return state

    kw = dict(backfill_blocks=backfill, sync_timeout_s=60.0, **pkg.kw)
    if knobs:
        kw["bootd_config"] = pkg.config.BootDConfig(**knobs)
    report: dict = {}
    if pkg is PORT:
        kw["report"] = report
    pkg.reactor.StateSyncReactor.sync = sync
    try:
        out = asyncio.run(pkg.tt.statesync_fleet_scenario(n_blocks, n_vals, n_joiners, **kw))
    finally:
        pkg.reactor.StateSyncReactor.sync = real
    return out, states, report


@pytest.mark.parametrize("case", sorted(WAVES))
def test_join_wave_matches_reference(case):
    (ref, ref_states, _), (port, port_states, report) = (_wave(pkg, case) for pkg in PKGS)
    n_joiners = WAVES[case][2]
    assert port["joined"] == ref["joined"] == n_joiners, (port["join_errors"], ref["join_errors"])
    assert port["join_errors"] == ref["join_errors"] == []
    assert port["headers_held"] == ref["headers_held"]
    assert all(h > 0 for h in port["headers_held"])
    # every joiner of both packages restored the same State
    assert len(set(port_states + ref_states)) == 1 and len(port_states) == n_joiners
    assert sorted(s.encode() for s in report["states"].values()) == sorted(port_states)
    ps, rs = port["server_stats"], ref["server_stats"]
    for k in ("chunks_served", "store_reads", "cache_hits", "cache_misses", "snapshots_served"):
        assert ps[k] == rs[k], k
    assert port["joiner_backfill"] == ref["joiner_backfill"]
    if case == "three_joiners":
        assert ps["store_reads"] < ps["chunks_served"] >= 3
        assert port["joiner_backfill"]["backfill_batches"] >= 3
    else:
        assert ps["chunk_requests"] >= ps["chunks_served"]


def _snapshot_app(pkg, seed, rate):
    """A poisoned donor holding one multi-chunk snapshot at height 10."""
    app = pkg.byz.PoisonedSnapshotApp(seed=seed, corrupt_rate=rate)
    app.items = {b"key%04d" % i: bytes([i % 251]) * 700 for i in range(300)}
    app.height = 10
    app._take_snapshot()
    return app


@pytest.mark.parametrize("seed,rate", [(0, 1.0), (7, 0.5), (3, 0.0)])
def test_poisoned_chunk_bytes_match_reference(seed, rate):
    served = []
    for pkg in PKGS:
        app = _snapshot_app(pkg, seed, rate)
        (snap,) = app.list_snapshots().snapshots
        honest = super(pkg.byz.PoisonedSnapshotApp, app)
        chunks = []
        for i in range(snap.chunks):
            req = pkg.abci.RequestLoadSnapshotChunk(10, snap.format, i)
            chunks.append((app.load_snapshot_chunk(req).chunk,
                           honest.load_snapshot_chunk(req).chunk))
        served.append((snap.chunks, chunks, app.poisoned_served))
    ref, port = served
    assert port == ref
    n_chunks, chunks, poisoned = port
    assert n_chunks >= 4
    differ = [i for i, (got, want) in enumerate(chunks) if got != want]
    assert len(differ) == poisoned
    assert poisoned == {1.0: n_chunks, 0.0: 0}.get(rate, poisoned)
    for i in differ:  # one byte flipped, the length kept
        got, want = chunks[i]
        assert len(got) == len(want) and sum(a != b for a, b in zip(got, want)) == 1


async def _poisoned_join(source):
    """One joiner, two donors over the same chain: "poisoned" serves the
    honest donor's snapshots through a PoisonedSnapshotApp; "honest"
    serves them as they are, but answers "missing" to chunk requests
    until the poisoned donor has served one (the joiner keeps its
    providers in a set, so either may be asked first)."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.p2p.peermanager import PeerStatus, PeerUpdate
    from tendermint_tpu_torch.p2p.router import Channel
    from tendermint_tpu_torch.p2p.types import Envelope
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.statesync import CHUNK_CHANNEL
    from tendermint_tpu_torch.statesync import messages as ssm
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor, SyncConfig
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB

    bstore, sstore, conns, genesis = source
    honest_app = conns.consensus.app
    poisoned_app = p_byz.PoisonedSnapshotApp(seed=9)
    poisoned_app.__dict__.update(
        {k: v for k, v in vars(honest_app).items() if k.startswith("_snapshot")}
    )

    def channels():
        return {cid: Channel(cid, "c", 5, ssm.encode_message, ssm.decode_message)
                for cid in (0x60, 0x61, 0x62, 0x63)}

    def reactor(app, chs, q, bs=bstore, ss=sstore):
        return StateSyncReactor(genesis.chain_id, app, ss, bs, *chs.values(), q, device="cpu")

    donors = {"poisoned": AppConns.local(poisoned_app), "honest": AppConns.local(honest_app)}
    donor_ch = {name: channels() for name in donors}
    servers = [reactor(app, donor_ch[name], asyncio.Queue()) for name, app in donors.items()]
    joiner_ch, q = channels(), asyncio.Queue()
    joiner_app = AppConns.local(KVStoreApp(MemDB()))
    joiner = reactor(joiner_app, joiner_ch, q, BlockStore(MemDB()), StateStore(MemDB()))

    async def to_donors(cid):
        while True:
            env = await joiner_ch[cid].out_q.get()
            msg = env.message
            if env.to == "honest" and cid == CHUNK_CHANNEL and not poisoned_app.poisoned_served:
                miss = ssm.ChunkResponse(msg.height, msg.format, msg.index, missing=True)
                await joiner_ch[cid].in_q.put(Envelope(cid, miss, from_="honest"))
                continue
            for name in [env.to] if env.to else list(donors):
                await donor_ch[name][cid].in_q.put(Envelope(cid, msg, from_="joiner"))

    async def from_donor(name, cid):
        while True:
            env = await donor_ch[name][cid].out_q.get()
            await joiner_ch[cid].in_q.put(Envelope(env.channel_id, env.message, from_=name))

    loop = asyncio.get_running_loop()
    pumps = [loop.create_task(to_donors(cid)) for cid in joiner_ch] + [
        loop.create_task(from_donor(name, cid)) for name in donors for cid in joiner_ch]
    for s in servers:
        await s.start()
    await joiner.start()
    for name in donors:
        await q.put(PeerUpdate(name, PeerStatus.UP))
    try:
        meta1 = bstore.load_block_meta(1)
        cfg = SyncConfig(trust_height=1, trust_hash=meta1.header.hash(),
                         trust_period_ns=10 * 365 * 24 * 3600 * 10**9)
        state = await asyncio.wait_for(joiner.sync(cfg), 60)
        errors = []
        while not joiner.chunk_ch.err_q.empty():
            e = joiner.chunk_ch.err_q.get_nowait()
            errors.append((e.node_id, e.ban, e.err))
        return {"state": state.encode(), "errors": errors,
                "poisoned_served": poisoned_app.poisoned_served,
                "stats": dict(joiner.bootd.stats)}
    finally:
        for t in pumps:
            t.cancel()
        await asyncio.gather(*pumps, return_exceptions=True)
        await joiner.stop()
        for s in servers:
            await s.stop()
        await joiner_app.stop()


def test_joiner_bans_a_poisoned_donor_and_restores_the_honest_state():
    from tendermint_tpu_torch.proxy import AppConns

    source = asyncio.run(p_tt.build_statesync_source(16, 4, device="cpu"))
    got = asyncio.run(_poisoned_join(source))
    # the same donor alone, honest: the State a clean restore gives
    bstore, sstore, conns, genesis = source
    report: dict = {}
    asyncio.run(p_tt.statesync_restore_scenario(
        16, 4, device="cpu", source=(bstore, sstore, AppConns.local(conns.consensus.app), genesis),
        report=report))
    assert got["poisoned_served"] >= 1
    assert [(peer, ban) for peer, ban, _err in got["errors"]] == [("poisoned", True)]
    assert "poisoned snapshot chunk at height 10" in got["errors"][0][2]
    assert got["stats"]["poisoned_rejects"] == 1
    assert got["state"] == report["state"].encode()
