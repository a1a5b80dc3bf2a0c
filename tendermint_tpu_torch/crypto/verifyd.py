"""VerifyD — the cross-process verification sidecar (the port of
tendermint_tpu/crypto/verifyd.py).

One process owns the card and serves signature verification to every
node process on the host over a Unix-domain socket:

  * **daemon** (`VerifyDaemon`, ``python -m tendermint_tpu_torch.cli
    verifyd``): owns one VerifyHub on its device ("cuda" by default;
    raises without a card unless "cpu" is asked for) and serves it over
    the socket. Requests from N client processes land in ONE hub's
    micro-batch lanes, so a single dispatch mixes several nodes'
    signatures (`cross_tenant_dispatches` in the hub stats): N batches
    each below the router's cutoff become one batch above it, which runs
    `kernel_eq` on the card. Its start pays the process's attach
    (`batch.warm_backend`: CUDA initialisation and the kernels' loads,
    crypto/backend_telemetry.py) before the first client needs it;
  * **client** (`VerifydClient`): the hub's `_verify_batch` ships its
    packed cold batches here when ``TMTPU_VERIFYD_SOCK`` /
    ``VerifyHubConfig.verifyd_sock`` is set. The window, verdict cache,
    coalescing and lanes all stay client-side.

Protocol: length-prefixed binary frames (4-byte big-endian length +
libs/protoenc fields — no pickle), byte-identical to the reference's,
with a versioned hello that pins the protocol version, the daemon's
scheme set and its shape-bucket ladder. ``verify_batch`` carries
per-item ``(key_type, pubkey, msg, sig, lane)``; ``verify_aggregate``
ships one BLS aggregate-commit check, which the daemon pairs on its
device off its event loop; ``stats`` returns the daemon's telemetry.

Robustness contract (the reference's): the sidecar can never be a
correctness or liveness event. The client wraps every socket operation
in a `libs/retry.CircuitBreaker`; a batch it does not get verdicts for
(breaker open, busy, error reply, socket error) returns None, counted in
``CLIENT_STATS["remote_fallbacks"]``, and the caller's hub verifies it
on its own device; a half-open probe re-adopts the remote route after a
daemon restart. The daemon sheds with an explicit ``busy`` reply past a
bounded in-flight cap instead of buffering.

Differences from the reference, by design: a device error in the
daemon's hub raises there (no host re-verify behind a breaker, as in the
whole port): it reaches the client as an error reply and is counted in
``daemon.errors`` and the hub's ``verify_errors``; the client then falls
back. `stop()` cancels the open connections before it waits for the
server to close, so a daemon with connected clients stops at once.

Env knobs (the reference's): TMTPU_VERIFYD_SOCK (client route, read by
the hub), TMTPU_VERIFYD_TIMEOUT (client I/O timeout, seconds),
TMTPU_VERIFYD_BREAKER_THRESHOLD / TMTPU_VERIFYD_BREAKER_RESET (client
breaker), TMTPU_VERIFYD_INFLIGHT (daemon in-flight signature cap before
busy-shedding).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import threading
import time
import weakref

from ..device import DEFAULT_DEVICE
from ..libs import protoenc as pe
from ..libs.metrics import Histogram
from ..libs.retry import CircuitBreaker
from . import pubkey_from_type_and_bytes

logger = logging.getLogger("crypto.verifyd")

#: protocol version pinned by the hello exchange; a mismatch makes the
#: client refuse the remote route (fall back local) rather than guess
PROTOCOL_VERSION = 1

#: one frame = 4-byte big-endian payload length + protoenc payload;
#: bounded so a corrupt/hostile peer cannot make either side allocate
#: unboundedly (a full 8192-sig batch of commit votes is ~2 MiB)
MAX_FRAME = 32 * 1024 * 1024

# message type codes (field 1 of every payload)
MSG_HELLO = 1
MSG_HELLO_OK = 2
MSG_VERIFY_BATCH = 3
MSG_VERDICTS = 4
MSG_VERIFY_AGGREGATE = 5
MSG_BUSY = 6
MSG_ERROR = 7
MSG_STATS = 8
MSG_STATS_OK = 9

#: wire codes for the hub scheduler lanes (0 is proto-omitted => live)
_LANE_WIRE = {"live": 1, "backfill": 2}
_LANE_NAME = {1: "live", 2: "backfill"}

#: key types the daemon advertises in its hello (everything the crypto
#: registry can decode — the daemon's hub scheme-partitions internally)
DAEMON_SCHEMES = ("bls12381", "ed25519", "secp256k1", "sr25519")


def bucket_ladder() -> list[int]:
    """The shape-bucket ladder of the daemon's device dispatch
    (crypto/cuda/verify._bucket: powers of two from `_MIN_BUCKET` up to
    `_MAX_BUCKET`, which TMTPU_MAX_BUCKET sets at import)."""
    from .cuda.verify import _MAX_BUCKET, _MIN_BUCKET

    lo, hi = _MIN_BUCKET, _MAX_BUCKET
    ladder, b = [], lo
    while b <= hi:
        ladder.append(b)
        b *= 2
    return ladder


# -- wire codec -------------------------------------------------------------


def _encode_item(key_type: str, pubkey: bytes, msg: bytes, sig: bytes, lane: str) -> bytes:
    return (
        pe.string_field(1, key_type)
        + pe.bytes_field(2, pubkey)
        + pe.bytes_field(3, msg)
        + pe.bytes_field(4, sig)
        + pe.varint_field(5, _LANE_WIRE.get(lane, 1))
    )


def _decode_item(data: bytes) -> tuple[str, bytes, bytes, bytes, str]:
    r = pe.Reader(data)
    key_type, pubkey, msg, sig, lane = "", b"", b"", b"", "live"
    while not r.eof():
        f, wt = r.read_tag()
        if f == 1:
            key_type = r.read_string()
        elif f == 2:
            pubkey = r.read_bytes()
        elif f == 3:
            msg = r.read_bytes()
        elif f == 4:
            sig = r.read_bytes()
        elif f == 5:
            lane = _LANE_NAME.get(r.read_uvarint(), "live")
        else:
            r.skip(wt)
    return key_type, pubkey, msg, sig, lane


def encode_hello(version: int = PROTOCOL_VERSION) -> bytes:
    return pe.varint_field(1, MSG_HELLO) + pe.varint_field(2, version)


def encode_hello_ok(
    version: int, schemes: tuple, ladder: list[int], epoch: bytes
) -> bytes:
    out = pe.varint_field(1, MSG_HELLO_OK) + pe.varint_field(2, version)
    for s in schemes:
        out += pe.string_field(3, s)
    for b in ladder:
        out += pe.varint_field(4, b)
    out += pe.bytes_field(5, epoch)
    return out


def encode_verify_batch(req_id: int, items: list) -> bytes:
    """items: [(key_type, pubkey_bytes, msg, sig, lane), ...]"""
    out = pe.varint_field(1, MSG_VERIFY_BATCH) + pe.varint_field(2, req_id)
    for key_type, pubkey, msg, sig, lane in items:
        out += pe.message_field(3, _encode_item(key_type, pubkey, msg, sig, lane))
    return out


def encode_verify_aggregate(
    req_id: int, keys: list, msgs: list[bytes], agg_sig: bytes
) -> bytes:
    """keys: [(key_type, pubkey_bytes), ...] — one message per signer."""
    out = pe.varint_field(1, MSG_VERIFY_AGGREGATE) + pe.varint_field(2, req_id)
    for key_type, pubkey in keys:
        out += pe.message_field(
            3, pe.string_field(1, key_type) + pe.bytes_field(2, pubkey)
        )
    for m in msgs:
        out += pe.message_field(4, bytes(m))
    out += pe.bytes_field(5, bytes(agg_sig))
    return out


def encode_verdicts(req_id: int, verdicts: list[bool]) -> bytes:
    return (
        pe.varint_field(1, MSG_VERDICTS)
        + pe.varint_field(2, req_id)
        + pe.bytes_field(3, bytes(1 if v else 0 for v in verdicts))
    )


def encode_busy(req_id: int) -> bytes:
    return pe.varint_field(1, MSG_BUSY) + pe.varint_field(2, req_id)


def encode_error(req_id: int, text: str) -> bytes:
    return (
        pe.varint_field(1, MSG_ERROR)
        + pe.varint_field(2, req_id)
        + pe.string_field(3, text[:512])
    )


def encode_stats(req_id: int) -> bytes:
    return pe.varint_field(1, MSG_STATS) + pe.varint_field(2, req_id)


def encode_stats_ok(req_id: int, payload: dict) -> bytes:
    return (
        pe.varint_field(1, MSG_STATS_OK)
        + pe.varint_field(2, req_id)
        + pe.bytes_field(3, json.dumps(payload, sort_keys=True).encode())
    )


# A 32 MiB frame (MAX_FRAME) can carry at most ~16M one-byte repeated
# fields, but a list of tiny decoded items amplifies memory well past
# the frame budget — clamp every repeat count explicitly. The in-flight
# cap sheds real batches far below this; the bound only exists so a
# hostile/corrupt frame raises instead of allocating.
MAX_REPEATED = 1 << 20


#: repeated-field clamp — the shared codec checker with this module's bound
_check_repeat = pe.check_repeat


def decode_message(data: bytes) -> tuple[int, dict]:
    """Decode one frame payload into (msg_type, fields). Unknown fields
    are skipped (forward compatibility); repeated fields collect into
    lists."""
    r = pe.Reader(data)
    msg_type = 0
    out: dict = {
        "req_id": 0,
        "version": 0,
        "schemes": [],
        "ladder": [],
        "epoch": b"",
        "items": [],
        "keys": [],
        "msgs": [],
        "agg_sig": b"",
        "verdicts": [],
        "error": "",
        "stats": None,
    }
    while not r.eof():
        f, wt = r.read_tag()
        if f == 1:
            msg_type = r.read_uvarint()
        elif f == 2:
            out["req_id" if msg_type != MSG_HELLO and msg_type != MSG_HELLO_OK else "version"] = (
                r.read_uvarint()
            )
        elif f == 3:
            if msg_type == MSG_HELLO_OK:
                out["schemes"].append(r.read_string())
                _check_repeat(out["schemes"], MAX_REPEATED, "schemes")
            elif msg_type == MSG_VERIFY_BATCH:
                out["items"].append(_decode_item(r.read_bytes()))
                _check_repeat(out["items"], MAX_REPEATED, "items")
            elif msg_type == MSG_VERIFY_AGGREGATE:
                kr = pe.Reader(r.read_bytes())
                kt, pk = "", b""
                while not kr.eof():
                    kf, kwt = kr.read_tag()
                    if kf == 1:
                        kt = kr.read_string()
                    elif kf == 2:
                        pk = kr.read_bytes()
                    else:
                        kr.skip(kwt)
                out["keys"].append((kt, pk))
                _check_repeat(out["keys"], MAX_REPEATED, "keys")
            elif msg_type == MSG_VERDICTS:
                out["verdicts"] = [bool(b) for b in r.read_bytes()]
            elif msg_type == MSG_ERROR:
                out["error"] = r.read_string()
            elif msg_type == MSG_STATS_OK:
                out["stats"] = json.loads(r.read_bytes())
            else:
                r.skip(wt)
        elif f == 4:
            if msg_type == MSG_HELLO_OK:
                out["ladder"].append(r.read_uvarint())
                _check_repeat(out["ladder"], MAX_REPEATED, "ladder")
            elif msg_type == MSG_VERIFY_AGGREGATE:
                out["msgs"].append(r.read_bytes())
                _check_repeat(out["msgs"], MAX_REPEATED, "msgs")
            else:
                r.skip(wt)
        elif f == 5:
            if msg_type == MSG_HELLO_OK:
                out["epoch"] = r.read_bytes()
            elif msg_type == MSG_VERIFY_AGGREGATE:
                out["agg_sig"] = r.read_bytes()
            else:
                r.skip(wt)
        else:
            r.skip(wt)
    return msg_type, out


def frame(payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)} > {MAX_FRAME}")
    return len(payload).to_bytes(4, "big") + payload


# -- daemon -----------------------------------------------------------------

#: live daemons in this process (in-process tests, /metrics fold)
_daemons: "weakref.WeakSet[VerifyDaemon]" = weakref.WeakSet()


def aggregate_daemons():
    """Fold every running in-process daemon's counters (for
    `libs.metrics.NodeMetrics`). Returns None when no daemon runs
    in this process (the usual node shape: the daemon is a separate OS
    process and its stats travel over the protocol instead)."""
    ds = [d for d in _daemons if d.is_running]
    if not ds:
        return None
    out = {
        "clients": 0.0,
        "requests": 0.0,
        "shed": 0.0,
        "cross_client_packs": 0.0,
        "batch_occupancy": 0.0,
    }
    for d in ds:
        s = d.stats
        out["clients"] += s["clients_now"]
        out["requests"] += s["requests"]
        out["shed"] += s["shed"]
        hs = d.hub.stats()
        out["cross_client_packs"] += hs.get("cross_tenant_dispatches", 0.0)
        out["batch_occupancy"] = max(out["batch_occupancy"], hs["mean_occupancy"])
    return out


class VerifyDaemon:
    """The sidecar server: one VerifyHub on `device` shared over a UDS.

    Owns its hub outright (constructed here, never the process-global
    `acquire_hub` singleton) so an in-process daemon can coexist with a
    client hub in the same interpreter without the remote route looping
    back into itself — the daemon's hub always has ``allow_remote=False``.
    `device` defaults to "cuda" and raises without a card unless "cpu"
    is asked for."""

    #: bound on signatures accepted-but-unanswered before busy-shedding:
    #: explicit backpressure, never unbounded buffering (the TxIngress
    #: contract, applied to the verification socket)
    DEFAULT_MAX_INFLIGHT = 8192

    def __init__(
        self,
        sock_path: str,
        *,
        device=DEFAULT_DEVICE,
        max_batch: int | None = None,
        window_ms: float | None = None,
        cache_size: int | None = None,
        max_inflight: int | None = None,
        warm_backend: bool = True,
        logger_: logging.Logger | None = None,
    ):
        from .verify_hub import VerifyHub

        self.sock_path = sock_path
        self.hub = VerifyHub(
            device=device,
            max_batch=max_batch,
            window_ms=window_ms,
            cache_size=cache_size,
            allow_remote=False,
            name="verifyd-hub",
        )
        env_cap = os.environ.get("TMTPU_VERIFYD_INFLIGHT")
        self.max_inflight = int(
            env_cap if env_cap else (max_inflight or self.DEFAULT_MAX_INFLIGHT)
        )
        self.warm_backend = warm_backend
        self.logger = logger_ or logger
        #: restart detector: clients see a fresh epoch after every boot
        self.epoch = os.urandom(8)
        self._inflight = 0
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._next_client = 0
        self.stats: dict[str, float] = {
            "clients_now": 0.0,      # connections currently open
            "clients_total": 0.0,    # connections accepted since boot
            "requests": 0.0,         # verify_batch requests served
            "sigs": 0.0,             # signatures verified for clients
            "agg_requests": 0.0,     # verify_aggregate requests served
            "shed": 0.0,             # busy replies (in-flight cap)
            "errors": 0.0,           # error replies (bad frames, wedges)
        }

    @property
    def is_running(self) -> bool:
        return self._server is not None

    @property
    def device(self):
        return self.hub.device

    async def start(self) -> None:
        if self.warm_backend:
            # this process pays the host's one attach (CUDA init and the
            # kernels' loads) before it listens, so no client's first
            # batch waits for it
            from .batch import warm_backend

            await asyncio.to_thread(warm_backend, self.device)
        if not self.hub.is_running:
            self.hub.start()
        parent = os.path.dirname(self.sock_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
        self._server = await asyncio.start_unix_server(
            self._handle_conn, path=self.sock_path
        )
        # the socket IS the verification trust boundary: only this uid
        os.chmod(self.sock_path, 0o600)
        _daemons.add(self)
        self.logger.info(
            "verifyd listening on %s (device %s, max_inflight=%d, hub max_batch=%d)",
            self.sock_path,
            self.device,
            self.max_inflight,
            self.hub.max_batch,
        )

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()
        # cancel the open connections BEFORE waiting on the server: since
        # Python 3.12 `wait_closed` waits for every connection to close,
        # and a connected client would hold it open forever
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        if server is not None:
            await server.wait_closed()
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
        self.hub.stop()

    # -- connection handling ------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self._next_client += 1
        client_id = self._next_client
        self.stats["clients_now"] += 1
        self.stats["clients_total"] += 1
        write_lock = asyncio.Lock()
        req_tasks: set[asyncio.Task] = set()
        try:
            # hello first: pin version / schemes / ladder / epoch before
            # any verification is served
            payload = await self._read_frame(reader)
            msg_type, fields = decode_message(payload)
            if msg_type != MSG_HELLO or fields["version"] != PROTOCOL_VERSION:
                await self._reply(
                    writer, write_lock,
                    encode_error(0, f"bad hello (want v{PROTOCOL_VERSION})"),
                )
                return
            await self._reply(
                writer, write_lock,
                encode_hello_ok(
                    PROTOCOL_VERSION, DAEMON_SCHEMES, bucket_ladder(), self.epoch
                ),
            )
            while True:
                payload = await self._read_frame(reader)
                msg_type, fields = decode_message(payload)
                # one task per request: a large batch awaiting the hub
                # must not head-of-line-block this client's next frame
                # (replies carry req_id, so order is free to vary)
                t = asyncio.get_running_loop().create_task(
                    self._serve_request(
                        writer, write_lock, client_id, msg_type, fields
                    )
                )
                req_tasks.add(t)
                t.add_done_callback(req_tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # client went away — routine
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — one bad client, not the daemon
            self.stats["errors"] += 1
            self.logger.warning("verifyd connection failed: %r", e)
        finally:
            self.stats["clients_now"] -= 1
            for t in req_tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                self.logger.debug("close of dead client failed: %r", e)
            self._conn_tasks.discard(task)

    async def _read_frame(self, reader) -> bytes:
        hdr = await reader.readexactly(4)
        n = int.from_bytes(hdr, "big")
        if n > MAX_FRAME:
            raise ConnectionError(f"oversized frame ({n} bytes)")
        return await reader.readexactly(n)

    async def _reply(self, writer, lock: asyncio.Lock, payload: bytes) -> None:
        async with lock:
            writer.write(frame(payload))
            await writer.drain()

    async def _serve_request(
        self, writer, write_lock, client_id: int, msg_type: int, fields: dict
    ) -> None:
        req_id = fields["req_id"]
        try:
            if msg_type == MSG_VERIFY_BATCH:
                await self._serve_verify_batch(
                    writer, write_lock, client_id, req_id, fields["items"]
                )
            elif msg_type == MSG_VERIFY_AGGREGATE:
                await self._serve_verify_aggregate(writer, write_lock, req_id, fields)
            elif msg_type == MSG_STATS:
                await self._reply(
                    writer, write_lock, encode_stats_ok(req_id, self.telemetry())
                )
            else:
                await self._reply(
                    writer, write_lock,
                    encode_error(req_id, f"unknown message type {msg_type}"),
                )
        except asyncio.CancelledError:
            raise
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # reply path died with the client
        except Exception as e:  # noqa: BLE001 — per-request failure only
            self.stats["errors"] += 1
            self.logger.warning("verifyd request %d failed: %r", req_id, e)
            try:
                await self._reply(writer, write_lock, encode_error(req_id, repr(e)))
            except asyncio.CancelledError:
                raise
            except Exception as e2:  # noqa: BLE001
                self.logger.debug("error reply undeliverable: %r", e2)

    async def _serve_verify_batch(
        self, writer, write_lock, client_id: int, req_id: int, items: list
    ) -> None:
        n = len(items)
        if self._inflight + n > self.max_inflight:
            # explicit backpressure: the client verifies locally this
            # once; shedding must never look like a verdict
            self.stats["shed"] += 1
            await self._reply(writer, write_lock, encode_busy(req_id))
            return
        self._inflight += n
        try:
            self.stats["requests"] += 1
            pubs = []
            for key_type, pk_bytes, _msg, _sig, _lane in items:
                try:
                    pubs.append(pubkey_from_type_and_bytes(key_type, pk_bytes))
                except Exception as e:  # noqa: BLE001
                    # an undecodable key here is VERSION SKEW, not data:
                    # the client held a real PubKey object, so its bytes
                    # decode on any daemon that knows the scheme. A
                    # fabricated False would be cached client-side as an
                    # authoritative verdict — reply error instead so the
                    # client's hub verifies the whole batch itself
                    self.stats["errors"] += 1
                    await self._reply(
                        writer, write_lock,
                        encode_error(
                            req_id, f"undecodable {key_type!r} key: {e!r}"
                        ),
                    )
                    return
            futs = [
                # tenant tag: the hub counts dispatches whose packed
                # batch mixes >1 client — the cross-client amortization
                # this daemon exists for, measured not assumed
                asyncio.wrap_future(
                    self.hub.submit_nowait(
                        pub, msg, sig, lane=lane, tenant=client_id
                    )
                )
                for pub, (_kt, _pk, msg, sig, lane) in zip(pubs, items)
            ]
            # bounded: a wedged hub must surface as an error reply
            # (client falls back local), never a silent stall
            results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120.0)
            self.stats["sigs"] += n
            await self._reply(
                writer, write_lock,
                encode_verdicts(req_id, [bool(ok) for ok in results]),
            )
        finally:
            self._inflight -= n

    async def _serve_verify_aggregate(
        self, writer, write_lock, req_id: int, fields: dict
    ) -> None:
        keys, msgs, agg_sig = fields["keys"], fields["msgs"], fields["agg_sig"]
        # aggregates ride the SAME bounded in-flight budget as batches,
        # weighted by signer count: one pairing-product check costs far
        # more than one Edwards signature, and N catch-up clients each
        # queuing minutes-scale pairings must shed, not buffer
        n = max(1, len(keys))
        if self._inflight + n > self.max_inflight:
            self.stats["shed"] += 1
            await self._reply(writer, write_lock, encode_busy(req_id))
            return
        self._inflight += n
        try:
            await self._do_verify_aggregate(
                writer, write_lock, req_id, keys, msgs, agg_sig
            )
        finally:
            self._inflight -= n

    async def _do_verify_aggregate(
        self, writer, write_lock, req_id: int, keys, msgs, agg_sig
    ) -> None:
        self.stats["agg_requests"] += 1
        try:
            pub_keys = [pubkey_from_type_and_bytes(kt, pk) for kt, pk in keys]
        except Exception as e:  # noqa: BLE001
            # version skew, same as verify_batch: never fabricate a
            # verdict — error out so the client runs the local path
            # (whose reject surface IS the authoritative one)
            self.stats["errors"] += 1
            await self._reply(
                writer, write_lock, encode_error(req_id, f"undecodable key: {e!r}")
            )
            return
        from .verify_hub import aggregate_cache_key

        key = aggregate_cache_key(pub_keys, msgs, agg_sig)
        hit = self.hub.cached_verdict(key)
        if hit is None:
            from .batch import bls_aggregate_verify

            # one indivisible pairing-product check on the daemon's
            # device, off the event loop so it cannot starve the socket
            hit = await asyncio.to_thread(
                bls_aggregate_verify, pub_keys, list(msgs), agg_sig, self.device
            )
            self.hub.store_verdict(key, bool(hit))
        await self._reply(writer, write_lock, encode_verdicts(req_id, [bool(hit)]))

    def telemetry(self) -> dict:
        """The daemon's full observable state, served over the protocol
        (its attach count is read from here)."""
        from . import backend_telemetry as bt

        hs = self.hub.stats()
        return {
            "protocol_version": PROTOCOL_VERSION,
            "epoch": self.epoch.hex(),
            "schemes": list(DAEMON_SCHEMES),
            "daemon": {k: v for k, v in self.stats.items()},
            "hub": {
                "dispatches": hs["dispatches"],
                "dispatched_sigs": hs["dispatched_sigs"],
                "mean_occupancy": hs["mean_occupancy"],
                "cache_hits": hs["cache_hits"],
                "coalesced": hs["coalesced"],
                "verify_errors": hs["verify_errors"],
                "cross_tenant_dispatches": hs.get("cross_tenant_dispatches", 0.0),
                "mesh_devices": hs["mesh_devices"],
            },
            "backend": {
                "attach_attempts": bt.BACKEND["attach_attempts"],
                "attach_failures": bt.BACKEND["attach_failures"],
                "active_kind": bt.ACTIVE["kind"],
                "compile_cache_hits": bt.BACKEND["compile_cache_hits"],
                "compile_cache_misses": bt.BACKEND["compile_cache_misses"],
            },
        }


# -- client -----------------------------------------------------------------

#: client-side counters, module-level like libs/metrics.RESILIENCE (the
#: remote route is process-wide, exactly like the crypto backends) —
#: rendered as verifyhub_remote_{dispatches,fallbacks,...} in /metrics
CLIENT_STATS: dict[str, float] = {
    "remote_dispatches": 0.0,   # batches answered by the daemon
    "remote_sigs": 0.0,         # signatures in those batches
    "remote_fallbacks": 0.0,    # batches the client's hub verified instead
    "remote_busy": 0.0,         # daemon shed us (healthy but loaded)
    "remote_agg_dispatches": 0.0,  # aggregate checks answered remotely
    "reconnects": 0.0,          # fresh connections (incl. re-adoption)
}

#: socket round-trip per remote batch (connect+send+verify+recv)
REMOTE_RTT = Histogram(
    "verifyhub_remote_rtt_seconds",
    "verifyd socket round-trip per remote batch",
    buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0, 5.0),
)


def remote_rtt_snapshot() -> tuple[list[int], float, int]:
    h = REMOTE_RTT
    return list(h._counts), h._sum, h._count


class VerifydClient:
    """Synchronous sidecar client, called from the hub's dispatch runner
    thread. One connection, serialized requests (the hub's runner is
    single-threaded; MAX_INFLIGHT_BATCHES buys pipelining at the hub
    layer, not here). Every failure path returns None — the caller's hub
    verifies the batch on its own device, so a sidecar crash costs
    latency, never a verdict."""

    def __init__(
        self,
        sock_path: str,
        *,
        connect_timeout: float | None = None,
        io_timeout: float | None = None,
    ):
        self.sock_path = sock_path
        self.connect_timeout = connect_timeout or 2.0
        self.io_timeout = io_timeout or float(
            os.environ.get("TMTPU_VERIFYD_TIMEOUT", "60")
        )
        # one failure trips (a dead daemon keeps failing, and the hub's
        # own route is always available); the half-open probe re-adopts
        # after restart
        self.breaker = CircuitBreaker(
            failure_threshold=int(
                os.environ.get("TMTPU_VERIFYD_BREAKER_THRESHOLD", "1")
            ),
            reset_timeout=float(os.environ.get("TMTPU_VERIFYD_BREAKER_RESET", "5")),
            name="verifyd-client",
        )
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._req_id = 0
        self.schemes: frozenset | None = None
        self.daemon_epoch: bytes = b""
        self.ladder: list[int] = []

    # -- connection management ----------------------------------------

    def _connect_locked(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.connect_timeout)
        try:
            s.connect(self.sock_path)
            s.settimeout(self.io_timeout)
            s.sendall(frame(encode_hello()))
            msg_type, fields = decode_message(self._recv_frame(s))
            if msg_type != MSG_HELLO_OK:
                raise ConnectionError(f"daemon refused hello: {fields['error']!r}")
            if fields["version"] != PROTOCOL_VERSION:
                raise ConnectionError(
                    f"protocol version mismatch: daemon v{fields['version']}, "
                    f"client v{PROTOCOL_VERSION}"
                )
        except BaseException:
            s.close()
            raise
        self._sock = s
        self.schemes = frozenset(fields["schemes"])
        self.ladder = fields["ladder"]
        if self.daemon_epoch and self.daemon_epoch != fields["epoch"]:
            logger.info(
                "verifyd restarted (epoch %s -> %s); remote route re-adopted",
                self.daemon_epoch.hex()[:8],
                fields["epoch"].hex()[:8],
            )
        self.daemon_epoch = fields["epoch"]
        CLIENT_STATS["reconnects"] += 1

    def _recv_frame(self, s: socket.socket) -> bytes:
        hdr = self._recv_exact(s, 4)
        n = int.from_bytes(hdr, "big")
        if n > MAX_FRAME:
            raise ConnectionError(f"oversized frame ({n} bytes)")
        return self._recv_exact(s, n)

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("daemon closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    # -- request plumbing ---------------------------------------------

    def _request(self, build) -> tuple[int, dict] | None:
        """One round-trip under the breaker. `build(req_id)` returns the
        encoded request. None = remote unavailable (breaker open, or the
        attempt failed and tripped it) — caller goes local."""
        if not self.breaker.allow():
            return None
        with self._lock:
            try:
                if self._sock is None:
                    self._connect_locked()
                self._req_id += 1
                req_id = self._req_id
                self._sock.sendall(frame(build(req_id)))
                while True:
                    msg_type, fields = decode_message(self._recv_frame(self._sock))
                    if fields["req_id"] == req_id:
                        break
                    # a reply for a request we gave up on earlier
                    # (timeout raised mid-stream) — skip it
            except Exception as e:  # noqa: BLE001 — ANY socket error degrades
                self._close_locked()
                opens_before = self.breaker.opens
                self.breaker.record_failure()
                if self.breaker.opens > opens_before:
                    logger.warning(
                        "verifyd unreachable (%r); breaker open — verifying "
                        "locally until the half-open probe reconnects",
                        e,
                    )
                return None
            self.breaker.record_success()
            return msg_type, fields

    # -- public API (the ONLY legal raw-socket verify path; the
    #    verify-chokepoint lint flags these names outside crypto/) -----

    def remote_verify_batch(self, items: list) -> list[bool] | None:
        """items: [(PubKey, msg, sig, lane), ...] -> per-item verdicts,
        or None when the caller must verify locally (breaker open,
        daemon busy/unreachable, or a scheme the daemon didn't pin)."""
        if self.schemes is not None and any(
            pk.TYPE not in self.schemes for pk, _m, _s, _l in items
        ):
            CLIENT_STATS["remote_fallbacks"] += 1
            return None
        t0 = time.monotonic()
        out = self._request(
            lambda req_id: encode_verify_batch(
                req_id,
                [(pk.TYPE, pk.bytes(), msg, sig, lane) for pk, msg, sig, lane in items],
            )
        )
        if out is None:
            CLIENT_STATS["remote_fallbacks"] += 1
            return None
        msg_type, fields = out
        if msg_type == MSG_BUSY:
            CLIENT_STATS["remote_busy"] += 1
            CLIENT_STATS["remote_fallbacks"] += 1
            return None
        if msg_type != MSG_VERDICTS or len(fields["verdicts"]) != len(items):
            CLIENT_STATS["remote_fallbacks"] += 1
            return None
        REMOTE_RTT.observe(time.monotonic() - t0)
        CLIENT_STATS["remote_dispatches"] += 1
        CLIENT_STATS["remote_sigs"] += len(items)
        return fields["verdicts"]

    def remote_verify_aggregate(
        self, pub_keys: list, msgs: list[bytes], agg_sig: bytes
    ) -> bool | None:
        if self.schemes is not None and any(
            pk.TYPE not in self.schemes for pk in pub_keys
        ):
            # same pin as verify_batch: a scheme the hello didn't cover
            # verifies locally. Before the first hello (schemes None)
            # the daemon's skew guard answers error, never a verdict.
            CLIENT_STATS["remote_fallbacks"] += 1
            return None
        out = self._request(
            lambda req_id: encode_verify_aggregate(
                req_id,
                [(pk.TYPE, pk.bytes()) for pk in pub_keys],
                [bytes(m) for m in msgs],
                bytes(agg_sig),
            )
        )
        if out is not None and out[0] == MSG_BUSY:
            CLIENT_STATS["remote_busy"] += 1
        if out is None or out[0] != MSG_VERDICTS or len(out[1]["verdicts"]) != 1:
            CLIENT_STATS["remote_fallbacks"] += 1
            return None
        CLIENT_STATS["remote_agg_dispatches"] += 1
        return out[1]["verdicts"][0]

    def remote_stats(self) -> dict | None:
        out = self._request(encode_stats)
        if out is None or out[0] != MSG_STATS_OK:
            return None
        return out[1]["stats"]


# process-wide client cache: every hub (and in-process multi-node tests
# share ONE hub anyway) routing to the same socket shares one breaker +
# connection — a flapping daemon is probed once per reset window, not
# once per hub. Aggregate checks ride a SEPARATE connection (purpose=
# "aggregate"): a multi-second pairing round-trip must not head-of-line
# block live vote batches behind the request lock.
_clients: dict[tuple, VerifydClient] = {}
_clients_lock = threading.Lock()


def client_for(sock_path: str, purpose: str = "batch") -> VerifydClient:
    with _clients_lock:
        key = (sock_path, purpose)
        c = _clients.get(key)
        if c is None:
            c = _clients[key] = VerifydClient(sock_path)
        return c


def reset_clients() -> None:
    """Test hook: drop cached connections/breakers between cases."""
    with _clients_lock:
        for c in _clients.values():
            c.close()
        _clients.clear()
    for k in CLIENT_STATS:
        CLIENT_STATS[k] = 0.0
