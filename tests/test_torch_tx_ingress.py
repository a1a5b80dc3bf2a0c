"""The port's TxIngress (tendermint_tpu_torch/mempool/ingress.py) against
the JAX package's, on the CPU.

A seeded flood (`testing.make_envelope_flood`: 64 senders × 4 nonces,
three senders' nonces reversed, three tampered signatures) plus
duplicates, bare txs and stale resubmissions goes through both
packages' ingresses in front of the same app, submitted in one event-loop
tick (so the intake bound sheds the same submissions), with a frozen
`ManualClock` that is advanced past the park timeout once the pipeline
has drained: both give the same admitted order (the pool's insertion
order, byte for byte), the same outcome for every submission (error type
and text) and the same ingress and pool stats. The envelope codec is
byte-equal; the five trace stages tile `admit`; and which device stage A
verifies on is pinned: with no hub, each envelope on the host; with a
CPU hub, through the hub's backfill lane, where a lowered
`MIN_TPU_BATCH` sends the batches to the plain `kernel_eq`. The
tolerance is zero."""

from __future__ import annotations

import asyncio
import types

import pytest
import torch

import tendermint_tpu.abci.application as j_app
import tendermint_tpu.abci.client as j_client
import tendermint_tpu.abci.types as j_abci
import tendermint_tpu.config as j_config
import tendermint_tpu.crypto.verify_hub as j_vh
import tendermint_tpu.libs.clock as j_clock
import tendermint_tpu.mempool.ingress as j_ing
import tendermint_tpu.mempool.pool as j_pool
import tendermint_tpu.testing as j_tt
import tendermint_tpu_torch.abci.application as p_app
import tendermint_tpu_torch.abci.client as p_client
import tendermint_tpu_torch.abci.types as p_abci
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.crypto.verify_hub as p_vh
import tendermint_tpu_torch.libs.clock as p_clock
import tendermint_tpu_torch.mempool.ingress as p_ing
import tendermint_tpu_torch.mempool.pool as p_pool
import tendermint_tpu_torch.testing as p_tt
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto.cuda import verify as p_verify
from tendermint_tpu_torch.libs import trace as p_trace

# the plain kernel_eq runs on small tensors: one intra-op thread per
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

REF = types.SimpleNamespace(
    app=j_app, client=j_client, abci=j_abci, config=j_config, vh=j_vh, clock=j_clock,
    ing=j_ing, pool=j_pool, hub_kw={},
)
PORT = types.SimpleNamespace(
    app=p_app, client=p_client, abci=p_abci, config=p_config, vh=p_vh, clock=p_clock,
    ing=p_ing, pool=p_pool, hub_kw={"device": "cpu"},
)

N_SENDERS, N_NONCES = 64, 4
TAMPERED = {(3, 1), (17, 0), (40, 3)}
REVERSED = {5, 6, 7}
PARK_MS = 3000.0


def _flood() -> list[bytes]:
    txs = p_tt.make_envelope_flood(
        N_SENDERS, N_NONCES, tampered=TAMPERED, reversed_clients=REVERSED
    )
    # duplicates while in the pipeline, bare txs (one app-rejected)
    return txs[:40] + txs[:3] + [b"7:bare", b"bad:bare", b"7:bare"] + txs[40:]


def make_pool(pkg, **cfg):
    abci = pkg.abci

    class FloodApp(pkg.app.BaseApplication):
        def check_tx(self, req):
            if b"bad" in req.tx:
                return abci.ResponseCheckTx(code=1, log="bad tx")
            return abci.ResponseCheckTx(priority=req.tx[-1], gas_wanted=1)

    return pkg.pool.PriorityMempool(pkg.config.MempoolConfig(**cfg), pkg.client.LocalClient(FloodApp()))


def _outcome(fut):
    if not fut.done():
        return "pending"
    e = fut.exception()
    return "ok" if e is None else (type(e).__name__, str(e))


async def _until(pred, timeout=30.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        assert loop.time() < deadline, "ingress did not drain"
        await asyncio.sleep(0.005)


async def flood_run(pkg, txs, *, depth=240, workers=8, hub=None) -> dict:
    """One flood through `pkg`'s ingress; everything observable."""
    clock = pkg.clock.ManualClock(start_ns=1_700_000_000_000_000_000)
    pool = make_pool(pkg, size=1000, cache_size=4000)
    cfg = pool.config.ingress
    cfg.depth, cfg.verify_workers, cfg.nonce_park_timeout_ms = depth, workers, PARK_MS
    if hub is not None:
        pkg.vh.acquire_hub(**pkg.hub_kw, **hub)
    ing = pkg.ing.TxIngress(cfg, pool, clock=clock)
    await ing.start()
    try:
        futs = [ing.submit_nowait(tx, source="peer-%d" % (i % 3)) for i, tx in enumerate(txs)]
        await _until(lambda: ing.occupancy == 0)
        parked_at_drain = ing.parked_count()
        # the gaps time out: fresh lanes adopt, established ones evict
        clock.advance(int(PARK_MS * 1e6) + 1)
        await ing._expire_parked()
        await _until(lambda: ing.parked_count() == 0)
        # resubmissions: an admitted tx, a stale nonce
        stale = p_ing.make_signed_tx(p_tt.det_priv_keys(N_SENDERS, b"tx-flood")[10], 0, b"again")
        late = [ing.submit_nowait(txs[0]), ing.submit_nowait(stale)]
        await _until(lambda: all(f.done() for f in late))
        out = {
            "outcomes": [_outcome(f) for f in futs + late],
            "admitted": [w.tx for w in sorted(pool._txs.values(), key=lambda w: w.seq)],
            "reaped": pool.reap_max_txs(-1),
            "ingress_stats": dict(ing.stats),
            "pool_stats": dict(pool.stats),
            "parked_at_drain": parked_at_drain,
        }
        if hub is not None:
            out["hub"] = pkg.vh.running_hub().stats()
        return out
    finally:
        await ing.stop()
        pool.close()
        if hub is not None:
            pkg.vh.release_hub()


def test_flood_bytes_equal_reference_signing():
    txs = p_tt.make_envelope_flood(4, 3, tampered={(1, 2)}, reversed_clients={2})
    keys = j_tt.det_priv_keys(4, b"tx-flood")
    want = []
    for ci, k in enumerate(keys):
        own = [j_ing.make_signed_tx(k, n, b"flood-%d-%d" % (ci, n)) for n in range(3)]
        want.extend(reversed(own) if ci == 2 else own)
    assert [t for i, t in enumerate(txs) if i != 5] == [t for i, t in enumerate(want) if i != 5]
    env, ref_env = p_ing.decode_envelope(txs[5]), j_ing.decode_envelope(want[5])
    assert env.signature != ref_env.signature and env.payload == ref_env.payload
    assert not env.pub_key().verify_signature(env.sign_bytes(), env.signature)


def test_envelope_codec_matches_reference():
    k = p_tt.det_priv_keys(1)[0]
    tx = p_ing.make_signed_tx(k, 7, b"payload")
    assert tx == j_ing.make_signed_tx(j_tt.det_priv_keys(1)[0], 7, b"payload")
    env = p_ing.decode_envelope(tx)
    assert p_ing.encode_envelope(env) == tx
    assert env.sign_bytes() == j_ing.decode_envelope(tx).sign_bytes()
    assert p_ing.decode_envelope(b"k=v") is None
    for bad in (tx[:10], b"stx1\xff\xff\xff",
                p_ing.encode_envelope(p_ing.TxEnvelope(k.TYPE, k.pub_key().bytes(), 0, b"p", b""))):
        errs = []
        for mod in (p_ing, j_ing):
            with pytest.raises(ValueError) as e:
                mod.decode_envelope(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.asyncio
async def test_flood_matches_reference_on_the_host_path():
    txs = _flood()
    ref = await flood_run(REF, txs)
    port = await flood_run(PORT, txs)
    assert port == ref
    st = port["ingress_stats"]
    # what the flood must have exercised
    assert st["shed"] > 0 and st["sig_failed"] == 3 and st["parked"] > 0
    assert st["park_expired"] > 0 and st["park_adopted"] > 0 and st["dedup_drops"] > 0
    assert st["stale_nonce"] >= 1 and port["parked_at_drain"] > 0
    assert len(port["admitted"]) > 150


@pytest.mark.asyncio
async def test_flood_through_a_hub_matches_the_host_path():
    """Stage A through a running hub (the port's on device="cpu", the
    reference's on the host) admits what the host path admits."""
    txs = _flood()
    host = await flood_run(PORT, txs, depth=1000, workers=16)
    ref = await flood_run(REF, txs, depth=1000, workers=16,
                          hub={"max_batch": 64, "window_ms": 1.0, "cache_size": 0})
    port = await flood_run(PORT, txs, depth=1000, workers=16,
                           hub={"max_batch": 64, "window_ms": 1.0, "cache_size": 0})
    for key in ("outcomes", "admitted", "reaped", "ingress_stats", "pool_stats"):
        assert port[key] == ref[key] == host[key], key
    assert port["hub"]["lane_backfill_submitted"] == ref["hub"]["lane_backfill_submitted"] > 0
    assert port["hub"]["verify_errors"] == 0


@pytest.mark.asyncio
async def test_stage_a_verifies_on_the_running_hubs_device(monkeypatch):
    """Where a node's ingress verifies: with no hub, each envelope alone on
    the host; with a hub, through its backfill lane on the hub's device —
    batches of at least MIN_TPU_BATCH signatures (lowered to 8 here) run
    the plain kernel_eq, which on a card hub is the kernel."""
    txs = p_tt.make_envelope_flood(24, 2, tampered={(4, 1)})
    calls = {"kernel_eq": 0, "host": 0}
    real_eq = p_verify.kernel_eq
    real_one = p_batch._verify_one

    def counting_eq(*a, **k):
        calls["kernel_eq"] += 1
        return real_eq(*a, **k)

    def counting_one(item):
        calls["host"] += 1
        return real_one(item)

    monkeypatch.setattr(p_verify, "kernel_eq", counting_eq)
    monkeypatch.setattr(p_batch, "_verify_one", counting_one)
    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 8)
    assert p_vh.running_hub() is None
    host = await flood_run(PORT, txs, depth=100, workers=48)
    assert calls == {"kernel_eq": 0, "host": 0}  # no hub: verify_signature inline
    hub = await flood_run(PORT, txs, depth=100, workers=48,
                          hub={"max_batch": 64, "window_ms": 50.0, "cache_size": 0})
    assert calls["kernel_eq"] >= 1
    # every envelope, and the late stale-nonce one (the admitted resubmission
    # stops at stage 0's cache check)
    assert hub["hub"]["lane_backfill_submitted"] == len(txs) + 1
    assert hub["hub"]["lane_live_submitted"] == 0
    for key in ("outcomes", "admitted", "ingress_stats"):
        assert hub[key] == host[key], key
    assert hub["ingress_stats"]["sig_failed"] == 1


@pytest.mark.asyncio
async def test_ingress_spans_tile_admit_exactly():
    old = p_trace.RECORDER.enabled
    p_trace.RECORDER.enabled = True
    p_trace.RECORDER.clear()
    pool = make_pool(PORT)
    ing = p_ing.TxIngress(pool.config.ingress, pool)
    await ing.start()
    try:
        await ing.submit_nowait(p_tt.make_envelope_flood(1, 1)[0])
    finally:
        await ing.stop()
        pool.close()
        p_trace.RECORDER.enabled = old
    by_name = {s["name"]: s for s in p_trace.RECORDER.dump(subsystem="mempool.ingress")}
    stages = ["intake", "verify", "nonce_lane", "checktx", "insert"]
    assert set(by_name) == set(stages) | {"admit"}
    root = by_name["admit"]
    assert root["attrs"]["outcome"] == "admitted"
    prev_end = root["start_s"]
    for name in stages:
        s = by_name[name]
        assert s["trace_id"] == root["trace_id"]
        assert abs(s["start_s"] - prev_end) < 2e-5
        prev_end = s["start_s"] + s["duration_ms"] / 1e3
    assert abs(prev_end - (root["start_s"] + root["duration_ms"] / 1e3)) < 2e-5


@pytest.mark.asyncio
async def test_aggregate_and_busy_after_stop():
    pool = make_pool(PORT)
    ing = p_ing.TxIngress(pool.config.ingress, pool)
    assert p_ing.aggregate() == (None, None, None)
    await ing.start()
    try:
        await ing.submit_nowait(b"5:a")
        s, admit, verify = p_ing.aggregate()
        assert s["submitted"] == 1 and s["depth"] == 0.0 and admit[2] == 1
    finally:
        await ing.stop()
        pool.close()
    with pytest.raises(p_ing.IngressBusyError, match="not running"):
        await ing.submit_nowait(b"5:b")
