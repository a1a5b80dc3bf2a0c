"""The port's verifyd sidecar (tendermint_tpu_torch/crypto/verifyd.py and
the VerifyHub's remote route) against the JAX package's, on the CPU.

The wire codec: every frame the port encodes is byte-equal to the
reference's, the port decodes the reference's frames, and the bucket
ladder is the same. The daemon on device="cpu" behind a port hub: the
verdicts of direct verification for mixed schemes and tampered items,
busy-shedding then fall-back, death then re-adoption through the
breaker's half-open probe, cross-client packing counted over two
tenants, the aggregate route on a committee of 3, version skew answered
with an error (never a False verdict), the bad hello, route "verifyd" on
the dispatch span, and the port's client against the reference's daemon.
Every daemon runs on its own event-loop thread and is stopped with its
thread joined; no client connection outlives its test. The tolerance is
zero (bytes, verdicts, counts)."""

from __future__ import annotations

import asyncio
import os
import socket as pysock
import tempfile
import threading
import time

import pytest

import tendermint_tpu.crypto.verifyd as j_vd
import tendermint_tpu_torch.crypto.verifyd as vd
from tendermint_tpu_torch.crypto import verify_hub as vh
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey
from tendermint_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.libs import trace


def _sock_path() -> str:
    # UDS paths are length-limited (~104 bytes): mint short ones
    return os.path.join(tempfile.mkdtemp(prefix="vd-"), "vd.sock")


class DaemonThread:
    """A daemon (the port's, or the reference's with `module=j_vd`) on its
    own event loop and thread. `stop()` is abrupt for a client: in-flight
    requests are cancelled and connections closed without a reply, the
    surface a killed daemon process shows."""

    def __init__(self, sock: str, module=vd, **kw):
        self.sock = sock
        self.module = module
        self.kw = dict(warm_backend=False, **kw)
        if module is vd:
            self.kw.setdefault("device", "cpu")
        self.daemon = None
        self.loop = None
        self._started = threading.Event()
        self._stop_ev = None
        self._thread = None

    def start(self) -> "DaemonThread":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._started.wait(10), "daemon failed to start"
        return self

    def _run(self):
        async def main():
            self.daemon = self.module.VerifyDaemon(self.sock, **self.kw)
            self.loop = asyncio.get_running_loop()
            self._stop_ev = asyncio.Event()
            await self.daemon.start()
            self._started.set()
            await self._stop_ev.wait()
            await self.daemon.stop()

        asyncio.run(main())

    def stop(self, timeout: float = 10.0):
        if self._thread is None or not self._thread.is_alive():
            return
        self.loop.call_soon_threadsafe(self._stop_ev.set)
        self._thread.join(timeout)
        assert not self._thread.is_alive(), "daemon thread leaked"


@pytest.fixture(autouse=True)
def _fresh_clients(monkeypatch):
    # a fast breaker, so the half-open re-adoption needs no long sleeps
    monkeypatch.setenv("TMTPU_VERIFYD_BREAKER_RESET", "0.2")
    monkeypatch.delenv("TMTPU_VERIFYD_SOCK", raising=False)
    vd.reset_clients()
    before = set(threading.enumerate())
    yield
    vd.reset_clients()
    # no daemon, hub or connection thread outlives its test (the host
    # verifier's process-wide pool, "sigverify", is shared by design)
    deadline = time.monotonic() + 5
    while True:
        left = [t for t in set(threading.enumerate()) - before
                if t.is_alive() and not t.name.startswith("sigverify")]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not left, left


def _hub(sock, **kw):
    hub = vh.VerifyHub(device="cpu", verifyd_sock=sock, window_ms=1.0, **{"cache_size": 0, **kw})
    hub.start()
    return hub


def _ed_items(n: int, tag: bytes = b"vd"):
    priv = Ed25519PrivKey(b"\x07" * 32)
    pub = priv.pub_key()
    return [(pub, tag + b"-%d" % i, priv.sign(tag + b"-%d" % i)) for i in range(n)]


# -- wire codec ---------------------------------------------------------------

BATCH_ITEMS = [
    ("ed25519", b"P" * 32, b"m", b"S" * 64, "backfill"),
    ("sr25519", b"Q" * 32, b"n", b"T" * 64, "live"),
    ("secp256k1", b"R" * 33, b"", b"U" * 64, "live"),
]
FRAMES = {
    "hello": lambda m: m.encode_hello(),
    "hello_v99": lambda m: m.encode_hello(version=99),
    "hello_ok": lambda m: m.encode_hello_ok(1, m.DAEMON_SCHEMES, [64, 128, 8192], b"e" * 8),
    "verify_batch": lambda m: m.encode_verify_batch(9, BATCH_ITEMS),
    "verify_batch_empty": lambda m: m.encode_verify_batch(0, []),
    "verify_aggregate": lambda m: m.encode_verify_aggregate(
        5, [("bls12381", b"K" * 48), ("bls12381", b"L" * 48)], [b"m1", b"m2"], b"G" * 96
    ),
    "verdicts": lambda m: m.encode_verdicts(4, [True, False, True]),
    "busy": lambda m: m.encode_busy(3),
    "error": lambda m: m.encode_error(3, "nope" * 200),
    "stats": lambda m: m.encode_stats(3),
    "stats_ok": lambda m: m.encode_stats_ok(3, {"b": [1, 2], "a": 1.0}),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_byte_equal_to_reference_and_decode_alike(name):
    ours, theirs = FRAMES[name](vd), FRAMES[name](j_vd)
    assert ours == theirs
    assert vd.frame(ours) == j_vd.frame(theirs)
    # each side decodes the other's frame to the same message
    assert vd.decode_message(theirs) == j_vd.decode_message(ours)


def test_constants_and_bucket_ladder_match_reference():
    for name in (
        "PROTOCOL_VERSION", "MAX_FRAME", "MAX_REPEATED", "DAEMON_SCHEMES",
        "MSG_HELLO", "MSG_HELLO_OK", "MSG_VERIFY_BATCH", "MSG_VERDICTS",
        "MSG_VERIFY_AGGREGATE", "MSG_BUSY", "MSG_ERROR", "MSG_STATS", "MSG_STATS_OK",
    ):
        assert getattr(vd, name) == getattr(j_vd, name), name
    assert vd.bucket_ladder() == j_vd.bucket_ladder() == [64, 128, 256, 512, 1024, 2048, 4096, 8192]
    assert set(vd.CLIENT_STATS) == set(j_vd.CLIENT_STATS)


def test_frame_bounds_and_unknown_fields():
    with pytest.raises(ValueError):
        vd.frame(b"x" * (vd.MAX_FRAME + 1))
    payload = (
        pe.varint_field(1, vd.MSG_BUSY) + pe.varint_field(2, 7)
        + pe.varint_field(9, 123) + pe.bytes_field(10, b"ignored")
    )
    assert vd.decode_message(payload) == j_vd.decode_message(payload)
    assert vd.decode_message(payload)[0] == vd.MSG_BUSY


# -- daemon and client, in process, over a real socket -------------------------


def test_mixed_scheme_batch_matches_direct_verification():
    sock = _sock_path()
    dt = DaemonThread(sock).start()
    hub = _hub(sock)
    try:
        ed = _ed_items(4, b"mix")
        sp = Secp256k1PrivKey(b"\x05" * 32)
        sec = [(sp.pub_key(), b"sec-%d" % i, sp.sign(b"sec-%d" % i)) for i in range(3)]
        sr = Sr25519PrivKey(b"\x09" * 32)
        srs = [(sr.pub_key(), b"sr-%d" % i, sr.sign(b"sr-%d" % i)) for i in range(2)]
        items = ed[:2] + sec[:1] + srs[:1] + ed[2:] + sec[1:] + srs[1:]
        # tamper one of each scheme: attribution survives the socket
        items[1] = (items[1][0], items[1][1], b"\x01" * 64)
        items[2] = (items[2][0], items[2][1] + b"x", items[2][2])
        items[3] = (items[3][0], items[3][1] + b"y", items[3][2])
        expect = [pk.verify_signature(m, s) for pk, m, s in items]
        assert expect == [True, False, False, False, True, True, True, True, True]
        assert hub.verify_many(items, timeout=30) == expect
        assert vd.CLIENT_STATS["remote_dispatches"] >= 1
        assert vd.CLIENT_STATS["remote_sigs"] >= len(items)
        assert vd.CLIENT_STATS["remote_fallbacks"] == 0
        assert dt.daemon.stats["sigs"] >= len(items)
        assert dt.daemon.stats["errors"] == 0
        assert hub.stats()["verify_errors"] == 0
        c = vd.client_for(sock)
        assert c.schemes == frozenset(vd.DAEMON_SCHEMES) and c.ladder == vd.bucket_ladder()
        tel = vd.client_for(sock).remote_stats()
        assert tel["schemes"] == list(vd.DAEMON_SCHEMES)
        assert tel["hub"]["verify_errors"] == 0 and tel["daemon"]["sigs"] >= len(items)
        assert set(tel["backend"]) == {
            "attach_attempts", "attach_failures", "active_kind",
            "compile_cache_hits", "compile_cache_misses",
        }
    finally:
        hub.stop()
        dt.stop()


def test_daemon_sheds_busy_past_inflight_cap_and_client_falls_back():
    sock = _sock_path()
    dt = DaemonThread(sock, max_inflight=2).start()
    hub = _hub(sock)
    try:
        assert hub.verify_many(_ed_items(8, b"busy"), timeout=30) == [True] * 8
        assert dt.daemon.stats["shed"] >= 1
        assert vd.CLIENT_STATS["remote_busy"] >= 1
        assert vd.CLIENT_STATS["remote_fallbacks"] >= 1
        # a shed is backpressure, not a failure: the breaker stays closed
        assert vd.client_for(sock).breaker.state == "closed"
    finally:
        hub.stop()
        dt.stop()


def test_daemon_death_falls_back_and_restart_readopts():
    sock = _sock_path()
    dt = DaemonThread(sock).start()
    hub = _hub(sock)
    try:
        assert hub.verify_many(_ed_items(4, b"pre"), timeout=30) == [True] * 4
        pre_remote = vd.CLIENT_STATS["remote_dispatches"]
        assert pre_remote >= 1
        dt.stop()
        bad = _ed_items(6, b"dead")
        bad[2] = (bad[2][0], bad[2][1], b"\x00" * 64)
        assert hub.verify_many(bad, timeout=30) == [True, True, False, True, True, True]
        assert vd.CLIENT_STATS["remote_fallbacks"] >= 1
        assert vd.CLIENT_STATS["remote_dispatches"] == pre_remote
        assert hub.stats()["verify_errors"] == 0
        breaker = vd.client_for(sock).breaker
        assert breaker.opens >= 1
        dt2 = DaemonThread(sock).start()
        try:
            deadline = time.monotonic() + 10
            i = 0
            while vd.CLIENT_STATS["remote_dispatches"] == pre_remote:
                assert time.monotonic() < deadline, "remote route never re-adopted"
                i += 1
                assert hub.verify_many(_ed_items(2, b"again-%d" % i), timeout=30) == [True] * 2
                time.sleep(0.05)
            assert breaker.state == "closed"
            assert dt2.daemon.epoch != dt.daemon.epoch
            assert vd.client_for(sock).daemon_epoch == dt2.daemon.epoch
        finally:
            dt2.stop()
    finally:
        hub.stop()


def test_cross_client_packing_counted_over_two_tenants():
    sock = _sock_path()
    dt = DaemonThread(sock, window_ms=150.0, max_batch=512).start()
    c1, c2 = vd.VerifydClient(sock), vd.VerifydClient(sock)
    try:
        quads = [(pk, m, s, "live") for pk, m, s in _ed_items(4, b"pack")]
        out: dict = {}
        threads = [
            threading.Thread(target=lambda k, c, q: out.__setitem__(k, c.remote_verify_batch(q)),
                             args=(k, c, q))
            for k, c, q in (("a", c1, quads[:2]), ("b", c2, quads[2:]))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert out == {"a": [True, True], "b": [True, True]}
        hs = dt.daemon.hub.stats()
        assert hs["cross_tenant_dispatches"] >= 1, hs
        assert dt.daemon.stats["clients_total"] == 2
        agg = vd.aggregate_daemons()
        assert agg["cross_client_packs"] >= 1 and agg["requests"] == 2
    finally:
        c1.close()
        c2.close()
        dt.stop()
    assert vd.aggregate_daemons() is None


def test_verify_aggregate_routes_remote_on_a_committee_of_three():
    from tendermint_tpu_torch.crypto.bls import BLSPrivKey, aggregate_signatures

    sock = _sock_path()
    dt = DaemonThread(sock).start()
    vh.acquire_hub(device="cpu", verifyd_sock=sock, window_ms=1.0)
    try:
        privs = [BLSPrivKey(bytes([i + 1]) * 32) for i in range(3)]
        msgs = [b"agg-vd-%d" % i for i in range(3)]
        agg = aggregate_signatures([p.sign(m) for p, m in zip(privs, msgs)])
        pubs = [p.pub_key() for p in privs]
        assert vh.verify_aggregate(pubs, msgs, agg, device="cpu") is True
        assert vd.CLIENT_STATS["remote_agg_dispatches"] == 1
        assert dt.daemon.stats["agg_requests"] == 1
        # the client-side verdict cache answers the re-verification
        assert vh.verify_aggregate(pubs, msgs, agg, device="cpu") is True
        assert vd.CLIENT_STATS["remote_agg_dispatches"] == 1
        bad = bytearray(agg)
        bad[0] ^= 0x01
        assert vh.verify_aggregate(pubs, msgs, bytes(bad), device="cpu") is False
        assert vd.CLIENT_STATS["remote_agg_dispatches"] == 2
        assert vd.CLIENT_STATS["remote_fallbacks"] == 0
    finally:
        vh.release_hub()
        dt.stop()


def test_version_skew_is_an_error_never_a_false_verdict(monkeypatch):
    sock = _sock_path()
    dt = DaemonThread(sock).start()
    hub = _hub(sock, cache_size=64)

    def skewed_decode(type_name, data):
        raise ValueError(f"daemon build predates scheme {type_name!r}")

    monkeypatch.setattr(vd, "pubkey_from_type_and_bytes", skewed_decode)
    try:
        items = _ed_items(3, b"skew")
        assert hub.verify_many(items, timeout=30) == [True] * 3
        assert dt.daemon.stats["errors"] >= 1
        assert vd.CLIENT_STATS["remote_fallbacks"] >= 1
        assert vd.CLIENT_STATS["remote_dispatches"] == 0
        # the cached verdicts are the true ones
        assert hub.verify_many(items, timeout=30) == [True] * 3
    finally:
        hub.stop()
        dt.stop()


def test_bad_hello_version_refused():
    sock = _sock_path()
    dt = DaemonThread(sock).start()
    s = pysock.socket(pysock.AF_UNIX, pysock.SOCK_STREAM)
    try:
        s.settimeout(5)
        s.connect(sock)
        s.sendall(vd.frame(vd.encode_hello(version=99)))
        hdr = vd.VerifydClient._recv_exact(s, 4)
        t, f = vd.decode_message(vd.VerifydClient._recv_exact(s, int.from_bytes(hdr, "big")))
        assert t == vd.MSG_ERROR and "hello" in f["error"]
    finally:
        s.close()
        dt.stop()


def test_dispatch_span_route_verifyd():
    sock = _sock_path()
    dt = DaemonThread(sock).start()
    hub = _hub(sock)
    was = trace.RECORDER.enabled
    trace.RECORDER.enabled = True
    try:
        assert hub.verify_many(_ed_items(3, b"span"), timeout=30) == [True] * 3
        spans = []
        deadline = time.monotonic() + 5
        while not spans and time.monotonic() < deadline:
            spans = [
                d for d in trace.RECORDER.dump(subsystem="hub")
                if d["name"] == "dispatch" and d.get("attrs", {}).get("route") == "verifyd"
            ]
            time.sleep(0.02)
        assert spans and spans[-1]["attrs"]["sigs"] >= 1
    finally:
        trace.RECORDER.enabled = was
        hub.stop()
        dt.stop()


def test_env_sock_routes_and_daemon_hub_never_routes_remote(monkeypatch):
    sock = _sock_path()
    monkeypatch.setenv("TMTPU_VERIFYD_SOCK", sock)
    assert vh.VerifyHub(device="cpu").verifyd_sock == sock
    assert vh.VerifyHub(device="cpu", verifyd_sock="/elsewhere").verifyd_sock == sock
    assert vh.VerifyHub(device="cpu", allow_remote=False).verifyd_sock == ""
    assert vd.VerifyDaemon(sock, device="cpu").hub.verifyd_sock == ""
    monkeypatch.delenv("TMTPU_VERIFYD_SOCK")
    assert vh.VerifyHub(device="cpu").verifyd_sock == ""
    assert vh.VerifyHub(device="cpu").stats()["cross_tenant_dispatches"] == 0.0


def test_port_client_against_the_reference_daemon():
    """The port's hub ships its batch to the JAX package's daemon (host
    verification there): same bytes on the wire, same verdicts."""
    sock = _sock_path()
    dt = DaemonThread(sock, module=j_vd).start()
    hub = _hub(sock)
    try:
        items = _ed_items(5, b"cross")
        items[3] = (items[3][0], items[3][1], b"\x02" * 64)
        assert hub.verify_many(items, timeout=30) == [True, True, True, False, True]
        assert vd.CLIENT_STATS["remote_dispatches"] >= 1
        assert vd.CLIENT_STATS["remote_fallbacks"] == 0
        assert dt.daemon.stats["sigs"] == 5
        assert vd.client_for(sock).daemon_epoch == dt.daemon.epoch
    finally:
        hub.stop()
        # the reference daemon's stop waits for its connections to close
        # (Python 3.12's Server.wait_closed): close ours first
        vd.reset_clients()
        dt.stop()


def test_daemon_device_error_is_an_error_reply_never_a_host_reverify():
    """A batch the daemon's hub fails (a device error there) reaches the
    client as an error reply, counted in the daemon's errors and its
    hub's verify_errors; the daemon does not re-verify on the host. The
    client's hub then verifies the batch on its own device."""
    sock = _sock_path()
    dt = DaemonThread(sock).start()
    hub = _hub(sock)

    def device_fault(batch):
        raise RuntimeError("CUDA kernel fe_mul failed to launch: error 700")

    dt.daemon.hub._verify_batch = device_fault
    try:
        items = _ed_items(4, b"fault")
        items[1] = (items[1][0], items[1][1], b"\x03" * 64)
        assert hub.verify_many(items, timeout=30) == [True, False, True, True]
        assert dt.daemon.stats["errors"] >= 1
        assert dt.daemon.hub.stats()["verify_errors"] >= 1
        assert dt.daemon.stats["sigs"] == 0
        assert vd.CLIENT_STATS["remote_fallbacks"] >= 1
        assert vd.CLIENT_STATS["remote_dispatches"] == 0
        # an error reply is not a socket failure: the breaker stays closed
        assert vd.client_for(sock).breaker.state == "closed"
        assert hub.stats()["verify_errors"] == 0
    finally:
        hub.stop()
        dt.stop()


def test_backend_telemetry_counts_the_first_device_use(monkeypatch):
    """The counters the daemon reports mean, on the card: one attach for
    the process's first `build_all` (CUDA initialisation and the kernels'
    loads, a failure counted too), a cache hit or miss per library
    loaded, and the active kind once a batch has run kernel_eq."""
    from tendermint_tpu_torch.crypto import backend_telemetry as bt
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.cuda import _build

    saved = dict(bt.BACKEND), dict(bt.ACTIVE)
    bt.BACKEND.update(dict.fromkeys(bt.BACKEND, 0.0))
    bt.ACTIVE["kind"] = "none"
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.torch.cuda, "init", lambda: None)

    def load(telemetry):
        # `_build_and_load` counts a library once, when it first loads
        for stem, hit in (("fe_mul", True), ("sha256", False)):
            if stem not in _build._libs:
                _build._libs[stem] = object()
                telemetry.record_compile_cache(hit)
        return {}

    try:
        monkeypatch.setattr(_build, "_build_and_load", lambda telemetry: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            _build.build_all()
        monkeypatch.setattr(_build, "_build_and_load", load)
        _build.build_all()
        _build.build_all()  # loaded: no second attach
        assert bt.BACKEND == {"attach_attempts": 2.0, "attach_failures": 1.0,
                              "compile_cache_hits": 1.0, "compile_cache_misses": 1.0}
        assert bt.ACTIVE["kind"] == "none"
        monkeypatch.setattr(batch, "MIN_TPU_BATCH", 2)
        bv = batch.create_batch_verifier(_ed_items(1)[0][0], "cpu")
        for pk, m, s in _ed_items(2, b"kind"):
            bv.add(pk, m, s)
        assert bv.verify()[0] and bt.ACTIVE["kind"] == "cpu"
        tel = vd.VerifyDaemon(_sock_path(), device="cpu").telemetry()["backend"]
        assert tel == {"attach_attempts": 2.0, "attach_failures": 1.0, "active_kind": "cpu",
                       "compile_cache_hits": 1.0, "compile_cache_misses": 1.0}
    finally:
        bt.BACKEND.update(saved[0])
        bt.ACTIVE.update(saved[1])
