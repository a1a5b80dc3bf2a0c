"""The port's VerifyHub (tendermint_tpu_torch/crypto/verify_hub.py) on the
CPU: the scheduling cases of tests/test_verify_hub.py (TestScheduling),
a differential against the reference hub (the same submission sequence
through both gives the same verdicts and the same submitted, cache-hit,
coalesced and lane counters), commit verification through a running hub
on ed25519, sr25519 and mixed ed25519 + secp256k1 sets against the
reference's (errors and failed_index), and a device error that
propagates out of the hub. Port hubs run with device="cpu", where
`kernel_eq` runs its plain version."""

import asyncio
import time
from dataclasses import replace as dc_replace

import pytest
import torch

from tendermint_tpu import testing as jtt
from tendermint_tpu.crypto import verify_hub as jvh
from tendermint_tpu.types import validation as jval
from tendermint_tpu_torch import testing as tt
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import verify_hub as vh
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey
from tendermint_tpu_torch.crypto.verify_hub import VerifyHub
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.types import validation as val

torch.set_num_threads(1)

CHAIN_ID = "hub-chain"


def _items(n, tag=b"vh", priv=None):
    priv = priv or Ed25519PrivKey(b"\x11" * 32)
    pub = priv.pub_key()
    out = []
    for i in range(n):
        msg = tag + b"-%d" % i
        out.append((pub, msg, priv.sign(msg)))
    return out


@pytest.fixture
def hub():
    """Standalone hub (not the process default) for scheduler tests."""
    h = VerifyHub(device="cpu", max_batch=8, window_ms=100.0, cache_size=256, adaptive=False)
    h.start()
    yield h
    h.stop()


class TestScheduling:
    def test_sync_facade_verdicts(self, hub):
        (pub, msg, sig), = _items(1)
        assert hub.verify_sync(pub, msg, sig) is True
        assert hub.verify_sync(pub, msg, b"\x00" * 64) is False

    def test_window_coalesces_concurrent_submissions(self, hub):
        futs = [hub.submit_nowait(pk, m, s) for pk, m, s in _items(4)]
        assert all(f.result(10.0) is True for f in futs)
        s = hub.stats()
        assert s["dispatches"] == 1, s
        assert s["dispatched_sigs"] == 4
        assert s["mean_occupancy"] == 4.0
        counts, total_s, n = hub.latency_snapshot()
        assert n == sum(counts) == 4 and total_s >= 0.0

    def test_full_batch_dispatches_before_window(self):
        h = VerifyHub(device="cpu", max_batch=8, window_ms=3000.0, cache_size=64, adaptive=False)
        h.start()
        try:
            t0 = time.monotonic()
            futs = [h.submit_nowait(pk, m, s) for pk, m, s in _items(8, b"full")]
            assert all(f.result(10.0) is True for f in futs)
            assert time.monotonic() - t0 < 2.0
            assert h.stats()["dispatches"] == 1
        finally:
            h.stop()

    def test_per_item_result_routing(self, hub):
        items = _items(6, b"route")
        pub, msg, _ = items[2]
        items[2] = (pub, msg, items[3][2])  # sig for a different msg
        assert hub.verify_many(items) == [True, True, False, True, True, True]

    def test_dedup_cache_hit(self, hub):
        (pub, msg, sig), = _items(1, b"dup")
        assert hub.verify_sync(pub, msg, sig) is True
        assert hub.verify_sync(pub, msg, sig) is True
        s = hub.stats()
        assert s["cache_hits"] == 1
        assert s["dispatched_sigs"] == 1
        assert hub.verify_sync(pub, msg, b"\x01" * 64) is False
        assert hub.verify_sync(pub, msg, b"\x01" * 64) is False
        assert hub.stats()["cache_hits"] == 2

    def test_inflight_duplicate_coalesces(self, hub):
        (pub, msg, sig), = _items(1, b"join")
        f1 = hub.submit_nowait(pub, msg, sig)
        f2 = hub.submit_nowait(pub, msg, sig)
        assert f1.result(10.0) is True and f2.result(10.0) is True
        s = hub.stats()
        assert s["coalesced"] == 1
        assert s["dispatched_sigs"] == 1

    def test_async_api(self, hub):
        items = _items(5, b"async")

        async def go():
            return await asyncio.gather(*(hub.verify(pk, m, s) for pk, m, s in items))

        assert asyncio.run(go()) == [True] * 5

    def test_clean_shutdown_resolves_inflight(self):
        h = VerifyHub(device="cpu", max_batch=16, window_ms=500.0, cache_size=64, adaptive=False)
        h.start()
        futs = [h.submit_nowait(pk, m, s) for pk, m, s in _items(40, b"drain")]
        h.stop()
        assert all(f.result(10.0) is True for f in futs)
        (pub, msg, sig), = _items(1, b"late")
        assert h.submit_nowait(pub, msg, sig).result(1.0) is True

    def test_verifier_exception_fails_batch_futures(self, hub, monkeypatch):
        def boom(_pk, _device):
            raise RuntimeError("verifier construction exploded")

        monkeypatch.setattr(vh, "create_batch_verifier", boom)
        futs = [hub.submit_nowait(pk, m, s) for pk, m, s in _items(3, b"err")]
        hub.flush()
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(10.0)
        assert hub.stats()["verify_errors"] == 1


_COUNTERS = (
    "submitted", "cache_hits", "coalesced", "dispatched_sigs",
    "lane_live_submitted", "lane_backfill_submitted",
    "lane_live_dispatched", "lane_backfill_dispatched", "lane_promotions",
)


def _sequence_window0(h, items, bad):
    """Window 0: groups and single calls, each answered before the next."""
    out = h.verify_many(items[0:6], lane="backfill")
    out += [h.verify_sync(*it) for it in items[0:3]]
    out += h.verify_many(items[4:10] + [bad], lane="live")
    out += [h.verify_sync(*bad), h.verify_sync(*items[7], lane="backfill")]
    return out


def _sequence_held(h, items, bad):
    """A window that never expires: duplicates coalesce onto queued
    entries (a live one promotes its backfill twin), then one flush."""
    futs = [h.submit_nowait(*it, lane="backfill") for it in items[0:4] + [bad]]
    futs.append(h.submit_nowait(*items[1], lane="live"))
    futs.append(h.submit_nowait(*items[2], lane="backfill"))
    futs.append(h.submit_nowait(*items[5], lane="live"))
    futs.append(h.submit_nowait(*bad, lane="live"))
    h.flush()
    out = [f.result(30.0) for f in futs]
    out.append(h.submit_nowait(*items[0]).result(30.0))
    return out


@pytest.mark.parametrize(
    "sequence, window_ms", [(_sequence_window0, 0.0), (_sequence_held, 60_000.0)],
    ids=["window0", "held"],
)
def test_hub_matches_reference(sequence, window_ms):
    from tendermint_tpu.crypto.ed25519 import Ed25519PrivKey as JPriv

    runs = []
    for hub_cls, priv_cls, kw in (
        (jvh.VerifyHub, JPriv, {}),
        (VerifyHub, Ed25519PrivKey, {"device": "cpu"}),
    ):
        items = _items(10, b"diff", priv_cls(b"\x21" * 32))
        pub, msg, sig = items[9]
        bad = (pub, msg + b"?", sig)
        h = hub_cls(max_batch=64, window_ms=window_ms, cache_size=256, adaptive=False, **kw)
        h.start()
        try:
            verdicts = sequence(h, items, bad)
        finally:
            h.stop()
        stats = h.stats()
        runs.append((verdicts, {k: stats[k] for k in _COUNTERS}))
    assert runs[1] == runs[0]
    if sequence is _sequence_held:
        assert runs[1][1]["coalesced"] == 3 and runs[1][1]["lane_promotions"] == 2


def _tamper(entries, ci, vi):
    vals, bid, h, commit = entries[ci]
    sigs = list(commit.signatures)
    s = sigs[vi].signature
    sigs[vi] = dc_replace(sigs[vi], signature=s[:5] + bytes([s[5] ^ 0x40]) + s[6:])
    out = list(entries)
    out[ci] = (vals, bid, h, dc_replace(commit, signatures=tuple(sigs)))
    return out


def _commits(mod, key_types, n_vals=4, heights=(1, 2, 3)):
    vals, keys = mod.make_validator_set(n_vals, key_types=key_types, seed=b"hub")
    return [
        (vals, bid, h, mod.make_commit(CHAIN_ID, h, 0, bid, vals, keys))
        for h in heights
        for bid in [mod.make_block_id(b"hub-%d" % h)]
    ]


def _outcome(fn):
    try:
        fn()
    except (jval.InvalidCommitError, val.InvalidCommitError) as e:
        return type(e).__name__, str(e), getattr(e, "failed_index", None)
    return None


@pytest.mark.parametrize("tampered", [False, True], ids=["valid", "tampered"])
@pytest.mark.parametrize(
    "key_types", [("ed25519",), ("sr25519",), ("ed25519", "secp256k1")],
    ids=["ed25519", "sr25519", "mixed"],
)
def test_commit_verification_through_hub_matches_reference(key_types, tampered, monkeypatch):
    """verify_commit_range, verify_commit_light and verify_commit through
    each package's running hub. MIN_TPU_BATCH 8 sends the batched range
    (9 signatures) through `kernel_eq` and each single commit (3 or 4) to
    the host."""
    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 8)
    monkeypatch.setattr(trace.RECORDER, "enabled", True)
    trace.RECORDER.clear()
    ref, port = _commits(jtt, key_types), _commits(tt, key_types)
    if tampered:
        ref, port = _tamper(ref, 2, 1), _tamper(port, 2, 1)
    jhub = jvh.acquire_hub(max_batch=64, window_ms=1.0, cache_size=256)
    phub = vh.acquire_hub(device="cpu", max_batch=64, window_ms=1.0, cache_size=256)
    try:
        got = [_outcome(lambda: val.verify_commit_range(CHAIN_ID, port, device="cpu"))]
        want = [_outcome(lambda: jval.verify_commit_range(CHAIN_ID, ref))]
        for (pv, pb, ph, pc), (rv, rb, rh, rc) in zip(port, ref):
            got.append(_outcome(lambda: val.verify_commit_light(CHAIN_ID, pv, pb, ph, pc, device="cpu")))
            want.append(_outcome(lambda: jval.verify_commit_light(CHAIN_ID, rv, rb, rh, rc)))
            got.append(_outcome(lambda: val.verify_commit(CHAIN_ID, pv, pb, ph, pc, device="cpu")))
            want.append(_outcome(lambda: jval.verify_commit(CHAIN_ID, rv, rb, rh, rc)))
        stats = phub.stats()
    finally:
        vh.release_hub()
        jvh.release_hub()
    assert vh.running_hub() is None
    assert got == want
    if tampered:
        assert got[0] == ("InvalidCommitError", "invalid signature at index 1", 2)
    else:
        assert got == [None] * 7
    assert stats["submitted"] > 0 and stats["cache_hits"] > 0
    routes = [s["attrs"]["route"] for s in trace.RECORDER.dump(subsystem="hub")
              if s["name"] == "dispatch"]
    batched = key_types != ("ed25519", "secp256k1")
    assert ("cuda" in routes) == batched and "cpu" in routes


def test_trace_spans_of_a_request(hub, monkeypatch):
    """A request that carries a trace gets its queue and execute spans
    (and a cache hit its marker) on that trace; the dispatch span
    carries the batch size and route."""
    monkeypatch.setattr(trace.RECORDER, "enabled", True)
    trace.RECORDER.clear()
    ctx = trace.start()
    items = _items(3, b"traced")
    futs = [hub.submit_nowait(*it, trace_ctx=ctx) for it in items]
    assert [f.result(10.0) for f in futs] == [True] * 3
    assert hub.submit_nowait(*items[0], trace_ctx=ctx).result(10.0) is True
    names = [s["name"] for s in trace.RECORDER.dump(trace_id=ctx.trace_id)]
    assert names.count("queue") == 3 and names.count("execute") == 3
    assert names[-1] == "cache_hit"
    (dispatch,) = [s for s in trace.RECORDER.dump(subsystem="hub") if s["name"] == "dispatch"]
    assert dispatch["attrs"] == {"sigs": 3, "route": "cpu"}
    monkeypatch.setattr(trace.RECORDER, "enabled", False)
    assert trace.start() is None


class _Crashing(pbatch.CPUBatchVerifier):
    def verify(self):
        raise RuntimeError("simulated kernel failure")


def test_device_error_propagates_through_hub(monkeypatch):
    """A failing device batch fails its futures; verify_many, verify_one
    and the commit funnel raise (the funnel does not verify again
    locally)."""

    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 1)
    monkeypatch.setattr(
        pbatch.AdaptiveBatchVerifier, "_make_device_verifier", lambda self: _Crashing()
    )
    vals, keys = tt.make_validator_set(4)
    bid = tt.make_block_id(b"err")
    commit = tt.make_commit(CHAIN_ID, 1, 0, bid, vals, keys)
    h = vh.acquire_hub(device="cpu", max_batch=64, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="simulated"):
            h.verify_many(_items(3, b"crash"))
        with pytest.raises(RuntimeError, match="simulated"):
            val.verify_commit_range(CHAIN_ID, [(vals, bid, 1, commit)], device="cpu")
        assert h.stats()["verify_errors"] == 2
    finally:
        vh.release_hub()
    assert vh.running_hub() is None
    with pytest.raises(RuntimeError, match="simulated"):
        val.verify_commit_light(CHAIN_ID, vals, bid, 1, commit, device="cpu")


def test_device_error_in_a_coalesced_hub_batch_raises_at_the_cutoff(monkeypatch):
    """Two concurrent commit verifications, each below the cutoff (4
    signatures against MIN_TPU_BATCH 8), share one hub batch of 8 that
    goes to the card and fails there: both raise. A local retry of
    either commit would land below the cutoff, on the host, and return
    a verdict for signatures the card failed to verify."""
    import threading

    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 8)
    monkeypatch.setattr(
        pbatch.AdaptiveBatchVerifier, "_make_device_verifier", lambda self: _Crashing()
    )
    vals, keys = tt.make_validator_set(4)
    commits = []
    for height in (1, 2):
        bid = tt.make_block_id(b"coalesced-%d" % height)
        commits.append((bid, height, tt.make_commit(CHAIN_ID, height, 0, bid, vals, keys)))
    h = vh.acquire_hub(device="cpu", max_batch=64, window_ms=1.0)
    outcomes = []
    try:
        # hold both in-flight slots so the dispatcher cannot pack until
        # both groups are queued: they leave as ONE batch of 8
        h._slots.acquire()
        h._slots.acquire()

        def run(bid, height, commit):
            try:
                val.verify_commit(CHAIN_ID, vals, bid, height, commit, device="cpu")
                outcomes.append("verified")
            except RuntimeError as e:
                outcomes.append(str(e))

        threads = [threading.Thread(target=run, args=c) for c in commits]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while h.stats()["submitted"] < 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        h._slots.release()
        h._slots.release()
        for t in threads:
            t.join(30.0)
        stats = h.stats()
    finally:
        vh.release_hub()
    assert outcomes == ["simulated kernel failure"] * 2
    assert stats["dispatches"] == 1 and stats["dispatched_sigs"] == 8
    assert stats["verify_errors"] == 1


def test_hub_knobs_come_from_the_constructor(monkeypatch):
    """The reference's TMTPU_VERIFYHUB_* env overrides are not read: the
    constructor's values hold, and VerifyHubConfig fills what it leaves
    out."""
    from tendermint_tpu_torch.config import VerifyHubConfig

    for name in ("BATCH", "WINDOW_MS", "CACHE"):
        monkeypatch.setenv(f"TMTPU_VERIFYHUB_{name}", "3")
    h = VerifyHub(device="cpu", max_batch=8192, window_ms=5.0, cache_size=16)
    assert (h.max_batch, h.window_s, h.cache_size) == (8192, 0.005, 16)
    d, cfg = VerifyHub(device="cpu"), VerifyHubConfig()
    assert (d.max_batch, d.window_s, d.cache_size) == (
        cfg.max_batch, cfg.window_ms / 1e3, cfg.cache_size
    )


def test_verify_one_passes_hub_errors_on(monkeypatch):
    """A failed dispatch reaches verify_one's and averify_one's callers;
    the reference verifies such a signature again inline on the host."""
    h = vh.acquire_hub(device="cpu", max_batch=8, window_ms=1.0)
    try:
        def boom(_batch):
            raise RuntimeError("dispatch exploded")

        monkeypatch.setattr(h, "_verify_batch", boom)
        items = _items(2, b"one")
        with pytest.raises(RuntimeError, match="exploded"):
            vh.verify_one(*items[0])
        with pytest.raises(RuntimeError, match="exploded"):
            asyncio.run(vh.averify_one(*items[1]))
        assert h.stats()["verify_errors"] == 2
    finally:
        vh.release_hub()
    (pub, msg, sig), = _items(1, b"nohub")
    assert vh.verify_one(pub, msg, sig) is True  # no hub: verified directly
    assert asyncio.run(vh.averify_one(pub, msg, sig)) is True


def test_unknown_lane_and_process_hub_lifecycle():
    h1 = vh.acquire_hub(device="cpu")
    h2 = vh.acquire_hub(device="cuda")  # the first acquirer's config wins
    try:
        assert h1 is h2 and vh.running_hub() is h1
        assert h1.device == torch.device("cpu") and h1.max_batch == 512
        with pytest.raises(ValueError, match="unknown verify lane"):
            h1.submit_nowait(*_items(1)[0], lane="bulk")
    finally:
        vh.release_hub()
        assert vh.running_hub() is h1
        vh.release_hub()
    assert vh.running_hub() is None and not h1.is_running


def test_concurrent_groups_and_singles_keep_the_counters_whole():
    """16 threads (more than the cores) submit overlapping groups and
    single signatures, with a short switch interval: every verdict is
    right, and every request is counted exactly once as submitted,
    cache hit or coalesced — a lost update or a double dispatch breaks
    the sums."""
    import sys
    import threading

    good = _items(24, b"stress")
    bad = [(pk, m + b"?", s) for pk, m, s in good[:4]]
    want = {(m, s): True for _, m, s in good} | {(m, s): False for _, m, s in bad}
    rows = good + bad
    h = VerifyHub(device="cpu", max_batch=16, window_ms=1.0, cache_size=8)
    h.start()
    errors, requests = [], [0]
    lock = threading.Lock()

    def worker(k):
        try:
            for r in range(6):
                group = [rows[(k * 5 + r * 7 + j) % len(rows)] for j in range(9)]
                lane = "live" if (k + r) % 2 else "backfill"
                got = h.verify_many(group, lane=lane)
                single = rows[(k + r) % len(rows)]
                got.append(h.verify_sync(*single, lane=lane))
                for (_pk, m, s), ok in zip(group + [single], got):
                    if ok != want[(m, s)]:
                        errors.append((m, s, ok))
                with lock:
                    requests[0] += len(group) + 1
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        h.stop()
    assert not errors, errors[:5]
    s = h.stats()
    assert s["submitted"] + s["cache_hits"] + s["coalesced"] == requests[0] == 16 * 6 * 10
    assert s["dispatched_sigs"] == s["submitted"] == (
        s["lane_live_submitted"] + s["lane_backfill_submitted"]
    )
    assert s["queued"] == 0 and s["verify_errors"] == 0
