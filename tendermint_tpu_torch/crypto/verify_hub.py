"""VerifyHub — node-wide micro-batching signature-verification scheduler
(the port of tendermint_tpu/crypto/verify_hub.py).

Every subsystem that needs a signature checked (vote intake, proposal
verification, the evidence pool, the light client, the verify_commit*
funnel) submits ``(pubkey, sign_bytes, sig)`` to the hub and awaits a
per-item verdict. The hub coalesces concurrent requests into
device-sized batches and runs one batched verify per dispatch through
`create_batch_verifier(pub_key, device)`, so the measured size cutoff
applies unchanged: a dispatch of at least `batch.MIN_TPU_BATCH`
signatures runs `kernel_eq` on the card (route "cuda"), a smaller one
runs on the host (route "cpu"). Each dispatch is partitioned by scheme:
ed25519/sr25519 ("edwards") and bls12381 ("bls", the pairing kernels)
never share a verifier.

Scheduling model (one dispatcher thread + one device-runner thread):

  * requests land in one of two FIFO lanes — ``live`` (consensus votes
    and proposals on the hot path) and ``backfill`` (block-sync /
    state-sync / light-client catch-up traffic). Each dispatch packs
    the live lane FIRST and only then fills the remaining batch
    capacity from backfill. Identical in-flight triples COALESCE onto
    one entry; a live submission coalescing onto a queued backfill
    entry PROMOTES it into the live lane;
  * a bounded LRU of already-verified ``(key_type, pubkey, sha256(msg),
    sig)`` verdicts answers repeats without any dispatch at all;
  * dispatch fires when a device-sized batch fills, when the adaptive
    micro-batch window expires, or immediately for *urgent* requests
    (the sync facade);
  * the window ADAPTS to measured occupancy: an EWMA of signatures per
    dispatch shrinks the window toward zero under light load and
    stretches it back to the configured ceiling as concurrency appears;
  * dispatch is double-buffered: at most two batches are in flight (one
    executing, one queued at the runner). The dispatcher waits for a
    free slot BEFORE packing, so an urgent/live arrival during a full
    double buffer still makes the very next dispatch.

The hub is process-wide (like the device it feeds): `acquire_hub` /
`release_hub` refcount node lifecycles. When no hub is running every
helper verifies directly — unit tests and library users pay nothing.

Differences from the reference, by design:

  * `verify_many` enqueues its whole group under one lock hold, so the
    dispatcher never packs half a group (a commit range of thousands of
    signatures stays one dispatch up to `max_batch`, as the reference's
    docstring intends);
  * a batch whose verifier raises fails its futures, and `verify_one`
    passes the error on: no helper re-verifies on the host, so a device
    error is never hidden;
  * `max_batch`, `window_ms` and `cache_size` come from the
    constructor, with `VerifyHubConfig`'s defaults; the reference's
    TMTPU_VERIFYHUB_* env overrides wait for the node config that
    reads them (TMTPU_VERIFYD_SOCK, the remote route's, is read);
  * `verify_aggregate` runs the pairing check on the caller's device
    (the hub lends only its verdict cache), as the reference runs it on
    the caller's thread;
  * `mesh_scale` comes from the constructor or `VerifyHubConfig`, as
    in the reference; its TMTPU_MESH_SCALE env override waits for the
    cli port, with the TMTPU_VERIFYHUB_* ones;
  * the remote route's fall-back is the hub's own device route: a batch
    the sidecar does not answer verifies on the hub's device (the card
    at or above the cutoff), never silently on the host; every
    fall-back is counted (crypto/verifyd.CLIENT_STATS).

Remote route (crypto/verifyd.py): when ``verifyd_sock`` (or
TMTPU_VERIFYD_SOCK, which wins) names a verifyd sidecar's Unix socket,
`_verify_batch` ships its packed cold batches to the daemon instead of
dispatching locally — the window, verdict cache, coalescing and lanes
all stay client-side, and the daemon re-batches across every client
process on the host (one card, N node processes). `verify_aggregate`
ships its check there too, on a connection of its own. A daemon's hub
has ``allow_remote=False``; it tags each client's signatures with a
tenant id, and `cross_tenant_dispatches` counts dispatches that packed
more than one client.

Mesh awareness: `max_batch` is a per-device target. With `mesh_scale`
on (the default), each dispatch iteration reads how many devices a
dispatch from the hub's device shards over (crypto/batch
`mesh_parallelism`, from crypto/cuda/mesh.py) and scales the pack
capacity and the adaptive window's ramp by it, so a mesh of four is fed
batches of 4 × max_batch; with it off, the capacity is `max_batch`
whatever the mesh. Sharded dispatches stamp each shard's device and real
signatures onto their hub.dispatch spans. A hub on the CPU never reads
CUDA.
"""


from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

from ..device import DEFAULT_DEVICE, resolve
from ..libs import trace
from ..libs.metrics import Histogram
from . import PubKey
from .batch import create_batch_verifier, supports_batch_verifier
from .hashes import sha256

logger = logging.getLogger("crypto.verify_hub")

#: scheduler lanes: live consensus is packed ahead of catch-up backfill
#: in every micro-batch (see module docstring)
LANE_LIVE = "live"
LANE_BACKFILL = "backfill"
LANES = (LANE_LIVE, LANE_BACKFILL)

#: queue-latency buckets (seconds) — sub-millisecond resolution, because
#: the whole point of the micro-batch window is single-digit-ms latency
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)


class _Pending:
    """One unique (pubkey, msg, sig) triple awaiting a verdict. Duplicate
    submissions while it is queued/in flight append their futures here
    (and their trace contexts — a coalesced duplicate still gets
    hub.queue/hub.execute spans on its own trace)."""

    __slots__ = (
        "key", "pub_key", "msg", "sig", "futures", "enqueued_at", "lane", "traces",
        "tenants",
    )

    def __init__(self, key, pub_key, msg, sig, fut, now, lane, trace_ctx=None, tenant=None):
        self.key = key
        self.pub_key = pub_key
        self.msg = msg
        self.sig = sig
        self.futures: list[Future] = [fut]
        self.enqueued_at = now
        self.lane = lane
        # (ctx, joined_at): a coalesced duplicate's queue wait starts
        # when IT joined, not when the first submitter enqueued
        self.traces: list | None = [(trace_ctx, now)] if trace_ctx is not None else None
        # multi-tenant tag (the verifyd daemon stamps each client's
        # connection id): a dispatch whose batch carries >1 distinct
        # tenant is a cross-client pack
        self.tenants: set | None = {tenant} if tenant is not None else None

    def add_tenant(self, tenant) -> None:
        if tenant is None:
            return
        if self.tenants is None:
            self.tenants = {tenant}
        else:
            self.tenants.add(tenant)

    def add_trace(self, trace_ctx) -> None:
        if trace_ctx is None:
            return
        entry = (trace_ctx, time.monotonic())
        if self.traces is None:
            self.traces = [entry]
        else:
            self.traces.append(entry)


def _cache_key(pub_key: PubKey, msg: bytes, sig: bytes) -> tuple:
    # hash the message so cache entries stay O(1)-sized regardless of
    # sign-bytes length; the pubkey+sig stay verbatim (fixed width)
    return (pub_key.TYPE, pub_key.bytes(), sha256(msg), sig)


class VerifyHub:
    """Per-process async verification service (see module docstring).
    `device` is where its batches verify ("cuda" by default; raises
    without a card unless "cpu" is asked for). `verifyd_sock` routes its
    batches through a verifyd sidecar; `allow_remote=False` (the
    daemon's own hub) ignores both it and TMTPU_VERIFYD_SOCK."""

    #: in-flight dispatch depth: one batch on the device, one packed and
    #: waiting — the double buffer. More adds queueing, not overlap.
    MAX_INFLIGHT_BATCHES = 2

    def __init__(
        self,
        *,
        device=DEFAULT_DEVICE,
        max_batch: int | None = None,
        window_ms: float | None = None,
        cache_size: int | None = None,
        adaptive: bool = True,
        mesh_scale: bool | None = None,
        verifyd_sock: str | None = None,
        allow_remote: bool = True,
        name: str = "verify-hub",
    ):
        # a knob left as None takes VerifyHubConfig's default
        from ..config import VerifyHubConfig

        defaults = VerifyHubConfig()
        if max_batch is None:
            max_batch = defaults.max_batch
        if window_ms is None:
            window_ms = defaults.window_ms
        if cache_size is None:
            cache_size = defaults.cache_size
        if mesh_scale is None:
            mesh_scale = defaults.mesh_scale
        # the sidecar route: TMTPU_VERIFYD_SOCK wins over the argument, as
        # in the reference; a daemon's own hub must never route back into
        # itself (allow_remote=False, not env-overridable)
        if allow_remote:
            verifyd_sock = os.environ.get("TMTPU_VERIFYD_SOCK") or (
                defaults.verifyd_sock if verifyd_sock is None else verifyd_sock
            )
        else:
            verifyd_sock = ""
        self.verifyd_sock = verifyd_sock or ""
        self.device = resolve(device)
        self.name = name
        self.max_batch = max(1, max_batch)
        self.window_s = max(0.0, window_ms) / 1e3
        self.cache_size = max(0, cache_size)
        self.adaptive = adaptive
        #: scale batch capacity + window by the mesh size: a mesh fed one
        #: device's batches runs each shard at 1/n occupancy
        self.mesh_scale = bool(mesh_scale)
        self._mesh_n = 1  # refreshed once per dispatch iteration

        self._cv = threading.Condition()
        # two FIFO lanes; dispatch packs live first, then backfill
        self._queues: dict[str, OrderedDict[tuple, _Pending]] = {
            lane: OrderedDict() for lane in LANES
        }
        self._inflight: dict[tuple, _Pending] = {}
        self._cache: OrderedDict[tuple, bool] = OrderedDict()
        self._urgent = False
        self._running = False
        self._thread: threading.Thread | None = None
        self._runner: ThreadPoolExecutor | None = None
        self._slots = threading.BoundedSemaphore(self.MAX_INFLIGHT_BATCHES)
        self._worker_ids: set[int] = set()
        # per-worker-thread route of the batch just verified (trace attrs)
        self._route_local = threading.local()
        # occupancy EWMA seeds at max_batch: start optimistic (full
        # window) and adapt DOWN
        self._ewma_occupancy = float(self.max_batch)
        self._started_at = time.monotonic()

        self.latency_hist = Histogram(
            "verifyhub_queue_latency_seconds",
            "submit-to-dispatch wait per request",
            buckets=LATENCY_BUCKETS,
        )
        self._stats = {
            "submitted": 0.0,      # unique triples enqueued
            "dispatches": 0.0,     # batches sent to a verifier
            "dispatched_sigs": 0.0,
            "cache_hits": 0.0,     # answered from the verdict LRU
            "coalesced": 0.0,      # joined an identical in-flight request
            "verify_errors": 0.0,  # batches whose verifier raised
            # per-lane accounting (live packed ahead of backfill)
            "lane_live_submitted": 0.0,
            "lane_backfill_submitted": 0.0,
            "lane_live_dispatched": 0.0,
            "lane_backfill_dispatched": 0.0,
            "lane_promotions": 0.0,  # backfill entries pulled into live
            # per-scheme dispatch accounting: ed25519/sr25519 share the
            # Edwards batch equation, bls12381 runs the pairing kernels
            "scheme_edwards_sigs": 0.0,
            "scheme_bls_sigs": 0.0,
            # multi-tenant packing (the verifyd daemon's hub): dispatches
            # whose batch mixed signatures from >1 client connection
            "cross_tenant_dispatches": 0.0,
        }

    # -- lifecycle -------------------------------------------------------

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self) -> None:
        if self._running:
            raise RuntimeError(f"{self.name} already started")
        self._running = True
        self._started_at = time.monotonic()
        self._runner = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{self.name}-runner"
        )
        self._thread = threading.Thread(
            target=self._dispatch_loop, name=f"{self.name}-dispatch", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Clean shutdown: everything already submitted is still
        dispatched and every outstanding future resolves before the
        worker threads exit."""
        with self._cv:
            if not self._running:
                return
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._runner is not None:
            self._runner.shutdown(wait=True)
            self._runner = None

    # -- submission ------------------------------------------------------

    def _submit_locked(
        self, pub_key, msg, sig, urgent, lane, trace_ctx, tenant=None
    ) -> tuple[Future, bool]:
        """Enqueue one triple; the caller holds `_cv`. Returns the future
        and whether the caller must verify inline (hub stopped, or a
        re-entrant call from a hub worker — never wait on ourselves)."""
        if lane not in self._queues:
            # a typo'd lane must fail loudly — a silent fall-through to
            # "live" would hand bulk catch-up traffic hot-path priority
            raise ValueError(f"unknown verify lane {lane!r}; use one of {LANES}")
        key = _cache_key(pub_key, msg, sig)
        fut: Future = Future()
        verdict = self._cache.get(key)
        if verdict is not None:
            self._cache.move_to_end(key)
            self._stats["cache_hits"] += 1
            if trace_ctx is not None:
                # zero-width marker anchored on the TRACE clock
                now = trace_ctx.clock.monotonic()
                trace.record(trace_ctx, "hub", "cache_hit", now, now, lane=lane)
            fut.set_result(verdict)
            return fut, False
        pending = (
            self._queues[LANE_LIVE].get(key)
            or self._queues[LANE_BACKFILL].get(key)
            or self._inflight.get(key)
        )
        if pending is not None:
            pending.futures.append(fut)
            pending.add_trace(trace_ctx)
            pending.add_tenant(tenant)
            self._stats["coalesced"] += 1
            if (
                lane == LANE_LIVE
                and pending.lane == LANE_BACKFILL
                and pending.key in self._queues[LANE_BACKFILL]
            ):
                # a live caller now waits on this triple: pull the
                # still-queued backfill entry into the live lane
                del self._queues[LANE_BACKFILL][pending.key]
                pending.lane = LANE_LIVE
                self._queues[LANE_LIVE][pending.key] = pending
                self._stats["lane_promotions"] += 1
            if urgent:
                self._urgent = True
                self._cv.notify_all()
            return fut, False
        if not self._running or threading.get_ident() in self._worker_ids:
            return fut, True
        q = self._queues[lane]
        q[key] = _Pending(
            key, pub_key, msg, sig, fut, time.monotonic(), lane,
            trace_ctx=trace_ctx, tenant=tenant,
        )
        self._stats["submitted"] += 1
        self._stats[f"lane_{lane}_submitted"] += 1
        if urgent:
            # head of the queue: a blocked caller jumps any bulk backlog
            q.move_to_end(key, last=False)
            self._urgent = True
        self._cv.notify_all()
        return fut, False

    @staticmethod
    def _verify_inline(fut: Future, pub_key, msg, sig) -> None:
        try:
            fut.set_result(pub_key.verify_signature(msg, sig))
        except Exception as e:  # noqa: BLE001 — the verdict carries it
            fut.set_exception(e)

    def submit_nowait(
        self,
        pub_key: PubKey,
        msg: bytes,
        sig: bytes,
        *,
        urgent: bool = False,
        lane: str = LANE_LIVE,
        trace_ctx=None,
        tenant=None,
    ) -> Future:
        """Enqueue one verification; returns a concurrent Future[bool].

        `urgent` skips the micro-batch window (the batch still takes
        every request queued at dispatch time). `lane` picks the
        scheduler lane: live consensus is packed ahead of backfill in
        every dispatch. `trace_ctx` (libs/trace.TraceCtx) joins the
        request to a trace: the hub records hub.queue and hub.execute
        spans on it. `tenant` tags the submitter (the verifyd daemon's
        client connection) for `cross_tenant_dispatches`."""
        with self._cv:
            fut, inline = self._submit_locked(
                pub_key, msg, sig, urgent, lane, trace_ctx, tenant
            )
        if inline:
            self._verify_inline(fut, pub_key, msg, sig)
        return fut

    def verify_sync(
        self,
        pub_key: PubKey,
        msg: bytes,
        sig: bytes,
        timeout: float | None = 60.0,
        *,
        lane: str = LANE_LIVE,
    ) -> bool:
        """Blocking facade for non-async callers. Urgent: a blocked
        caller can't generate more load, so waiting out the window would
        be pure added latency."""
        return self.submit_nowait(pub_key, msg, sig, urgent=True, lane=lane).result(
            timeout
        )

    async def verify(
        self,
        pub_key: PubKey,
        msg: bytes,
        sig: bytes,
        *,
        lane: str = LANE_LIVE,
        trace_ctx=None,
    ) -> bool:
        """Async API: awaits the batched verdict without blocking the
        event loop; concurrent awaiters coalesce into one dispatch."""
        return await asyncio.wrap_future(
            self.submit_nowait(pub_key, msg, sig, lane=lane, trace_ctx=trace_ctx)
        )

    def verify_many(
        self,
        items: list[tuple[PubKey, bytes, bytes]],
        timeout: float | None = 300.0,
        *,
        lane: str = LANE_LIVE,
    ) -> list[bool]:
        """Submit a group (e.g. every signature of a commit range) and
        wait for all verdicts. The group is enqueued under one lock hold
        and flushed as one urgent dispatch — plus whatever else is
        queued, so concurrent commit verifications share kernel
        launches."""
        with self._cv:
            subs = [
                self._submit_locked(pk, msg, sig, False, lane, None)
                for pk, msg, sig in items
            ]
            self._urgent = True
            self._cv.notify_all()
        for (fut, inline), (pk, msg, sig) in zip(subs, items):
            if inline:
                self._verify_inline(fut, pk, msg, sig)
        return [fut.result(timeout) for fut, _ in subs]

    def flush(self) -> None:
        """Dispatch everything currently queued without waiting out the
        micro-batch window."""
        with self._cv:
            self._urgent = True
            self._cv.notify_all()

    # -- introspection ---------------------------------------------------

    # -- out-of-band verdict cache (aggregate commits) --------------------

    def cached_verdict(self, key: tuple):
        """Consult the verdict LRU for a non-triple key (the aggregate
        commit path: one indivisible pairing-product check has nothing to
        micro-batch, but gossip re-verifications still dedup)."""
        with self._cv:
            v = self._cache.get(key)
            if v is not None:
                self._cache.move_to_end(key)
                self._stats["cache_hits"] += 1
            return v

    def store_verdict(self, key: tuple, ok: bool) -> None:
        with self._cv:
            if self.cache_size:
                self._cache[key] = ok
                self._cache.move_to_end(key)
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)

    def latency_snapshot(self) -> tuple[list[int], float, int]:
        """Consistent copy of the queue-latency histogram internals
        (observe() runs under the same lock in the dispatcher)."""
        with self._cv:
            h = self.latency_hist
            return list(h._counts), h._sum, h._count

    def stats(self) -> dict:
        with self._cv:
            s = dict(self._stats)
            s["queued"] = float(self._queued())
            s["lane_live_queued"] = float(len(self._queues[LANE_LIVE]))
            s["lane_backfill_queued"] = float(len(self._queues[LANE_BACKFILL]))
            s["cache_size"] = float(len(self._cache))
            s["mean_occupancy"] = (
                s["dispatched_sigs"] / s["dispatches"] if s["dispatches"] else 0.0
            )
            s["ewma_occupancy"] = self._ewma_occupancy
            s["mesh_devices"] = float(self._mesh_n)
            s["effective_max_batch"] = float(self._effective_max())
            uptime = max(time.monotonic() - self._started_at, 1e-9)
            s["dispatch_rate"] = s["dispatches"] / uptime
            requests = s["submitted"] + s["cache_hits"] + s["coalesced"]
            s["cache_hit_rate"] = s["cache_hits"] / requests if requests else 0.0
        return s

    # -- scheduling internals --------------------------------------------

    def _refresh_mesh(self) -> int:
        """The mesh size, read once per dispatch iteration (1 with
        `mesh_scale` off)."""
        if self.mesh_scale:
            from .batch import mesh_parallelism

            self._mesh_n = mesh_parallelism(self.device)
        else:
            self._mesh_n = 1
        return self._mesh_n

    def _effective_max(self) -> int:
        """The batch capacity: one `max_batch` per device of the mesh."""
        return self.max_batch * self._mesh_n

    def _window(self) -> float:
        """Adaptive micro-batch window: scale the configured ceiling by
        recent occupancy, so an idle node's stray vote dispatches
        immediately while a gossip storm fills device-sized batches."""
        if not self.adaptive:
            return self.window_s
        occ = self._ewma_occupancy
        if occ <= 1.0:
            return 0.0
        # linear ramp: full window once recent batches average >= 1/8 of
        # a device batch (past that, latency is already amortized); the
        # device batch is max_batch per device of the mesh
        frac = min(1.0, (occ - 1.0) / max(self._effective_max() / 8.0, 1.0))
        return self.window_s * frac

    def _queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _dispatch_loop(self) -> None:
        self._worker_ids.add(threading.get_ident())
        while True:
            # outside the lock: submitters keep filling the lanes
            self._refresh_mesh()
            with self._cv:
                while self._running and not self._queued():
                    self._cv.wait(0.2)
                if not self._queued():
                    if not self._running:
                        return
                    continue
                # micro-batch window: linger for more arrivals unless the
                # batch is device-sized (one max_batch per device of the
                # mesh), someone is blocked (urgent), or the hub is
                # draining for shutdown
                if self._running:
                    oldest = min(
                        next(iter(q.values())).enqueued_at
                        for q in self._queues.values()
                        if q
                    )
                    deadline = oldest + self._window()
                    while (
                        self._running
                        and not self._urgent
                        and self._queued() < self._effective_max()
                    ):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
            # wait for an in-flight slot BEFORE packing (outside the
            # lock: submitters must keep filling the lanes meanwhile), so
            # a live/urgent arrival during a full double buffer still
            # rides the very next dispatch. Only this thread pops the
            # queues, so the batch cannot vanish between the window wait
            # and the pack.
            self._slots.acquire()
            with self._cv:
                batch = self._pack_batch()
                if not self._queued():
                    self._urgent = False
                now = time.monotonic()
                for p in batch:
                    self.latency_hist.observe(now - p.enqueued_at)
                    if p.traces:
                        # queue span: submit-to-pack wait, per joined
                        # trace, measured on the system clock and
                        # anchored at the trace clock's now
                        for ctx, joined in p.traces:
                            tc_now = ctx.clock.monotonic()
                            trace.record(
                                ctx, "hub", "queue",
                                tc_now - max(0.0, now - joined), tc_now,
                                lane=p.lane,
                            )
                self._stats["dispatches"] += 1
                self._stats["dispatched_sigs"] += len(batch)
                tenants: set = set()
                for p in batch:
                    if p.tenants:
                        tenants.update(p.tenants)
                if len(tenants) > 1:
                    # >1 verifyd client packed into one dispatch: the
                    # cross-process amortization the sidecar exists for
                    self._stats["cross_tenant_dispatches"] += 1
                alpha = 0.2
                self._ewma_occupancy = (
                    (1 - alpha) * self._ewma_occupancy + alpha * len(batch)
                )
            # hand off outside the lock; the runner's done-callback
            # frees the slot
            fut = self._runner.submit(self._run_batch, batch)
            fut.add_done_callback(lambda _f: self._slots.release())

    def _pack_batch(self) -> list[_Pending]:
        """Pop up to the mesh-scaled batch capacity, live lane FIRST —
        catch-up traffic can never displace the hot path. Caller holds
        _cv."""
        cap = self._effective_max()
        batch: list[_Pending] = []
        for lane in LANES:
            q = self._queues[lane]
            while q and len(batch) < cap:
                _, p = q.popitem(last=False)
                self._inflight[p.key] = p
                batch.append(p)
                self._stats[f"lane_{lane}_dispatched"] += 1
        return batch

    def _run_batch(self, batch: list[_Pending]) -> None:
        self._worker_ids.add(threading.get_ident())
        t0 = time.monotonic()
        try:
            results = self._verify_batch(batch)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the hub
            logger.warning("batch of %d failed to verify: %r", len(batch), e)
            with self._cv:
                self._stats["verify_errors"] += 1
                for p in batch:
                    self._inflight.pop(p.key, None)
            for p in batch:
                for f in p.futures:
                    if not f.done():
                        f.set_exception(e)
            return
        with self._cv:
            for p, ok in zip(batch, results):
                self._inflight.pop(p.key, None)
                if self.cache_size:
                    self._cache[p.key] = ok
                    self._cache.move_to_end(p.key)
                    while len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
        if trace.is_enabled():
            # per-batch dispatch span + per-trace execute spans, stamped
            # with where THIS batch ran (the thread-local route that
            # _verify_batch stashed); a sharded dispatch adds each shard's
            # device id and real signatures
            route = getattr(self._route_local, "route", "cpu")
            disp = getattr(self._route_local, "dispatch", None)
            t1 = time.monotonic()
            trace.emit(
                "hub", "dispatch", duration_s=t1 - t0, sigs=len(batch), route=route,
                **({"devices": disp["devices"], "shards": disp["shards"]} if disp else {}),
            )
            for p in batch:
                if p.traces:
                    for ctx, _ in p.traces:
                        tc_now = ctx.clock.monotonic()
                        trace.record(
                            ctx, "hub", "execute", tc_now - (t1 - t0), tc_now,
                            batch=len(batch), route=route,
                        )
        for p, ok in zip(batch, results):
            for f in p.futures:
                if not f.done():
                    f.set_result(ok)

    def _remote(self, purpose: str = "batch"):
        """The verifyd client for this hub's socket (process-wide, one
        connection and breaker per socket and purpose: aggregates ride a
        connection of their own), or None without a remote route."""
        if not self.verifyd_sock:
            return None
        from . import verifyd

        return verifyd.client_for(self.verifyd_sock, purpose)

    def _verify_batch(self, batch: list[_Pending]) -> list[bool]:
        """One batched verify per scheme per dispatch (reference
        verify_hub.py:735).

        Remote route first: with a verifyd sidecar configured, the whole
        packed batch ships over the socket and the daemon's hub
        re-batches it across client processes (route "verifyd" on the
        dispatch span). A batch the sidecar does not answer (breaker
        open, busy, error reply, socket error: the client returns None
        and counts a fall-back) goes on to the local path below.

        Local path: the batchable key types are partitioned by scheme,
        ed25519/sr25519 ("edwards") and bls12381 ("bls"), and each
        partition goes to its own AdaptiveBatchVerifier on the hub's
        device (device/host routing by size lives there); anything
        unbatchable (secp256k1), and a partition of one signature,
        verifies on the host."""
        remote = self._remote()
        if remote is not None:
            verdicts = remote.remote_verify_batch(
                [(p.pub_key, p.msg, p.sig, p.lane) for p in batch]
            )
            if verdicts is not None:
                self._route_local.route = "verifyd"
                self._route_local.dispatch = None
                with self._cv:
                    for p in batch:
                        if supports_batch_verifier(p.pub_key):
                            scheme = "bls" if p.pub_key.TYPE == "bls12381" else "edwards"
                            self._stats[f"scheme_{scheme}_sigs"] += 1
                return verdicts
        results = [False] * len(batch)
        groups: dict[str, list[int]] = {}
        for i, p in enumerate(batch):
            if supports_batch_verifier(p.pub_key):
                scheme = "bls" if p.pub_key.TYPE == "bls12381" else "edwards"
                groups.setdefault(scheme, []).append(i)
            else:
                results[i] = p.pub_key.verify_signature(p.msg, p.sig)
        # where this batch ran, for the dispatch/execute spans: set per
        # worker thread, and "cpu" on the host-side paths
        self._route_local.route = "cpu"
        self._route_local.dispatch = None
        if groups:
            with self._cv:
                for scheme, idxs in groups.items():
                    self._stats[f"scheme_{scheme}_sigs"] += len(idxs)
        for idxs in groups.values():
            if len(idxs) == 1:
                p = batch[idxs[0]]
                results[idxs[0]] = p.pub_key.verify_signature(p.msg, p.sig)
                continue
            bv = create_batch_verifier(batch[idxs[0]].pub_key, self.device)
            for i in idxs:
                p = batch[i]
                bv.add(p.pub_key, p.msg, p.sig)
            _ok, bitmap = bv.verify()
            if bv.last_route != "cpu" or len(groups) == 1:
                # a mixed dispatch that reached the device reads as such
                self._route_local.route = bv.last_route
                self._route_local.dispatch = getattr(bv, "last_dispatch", None)
            for i, good in zip(idxs, bitmap):
                results[i] = bool(good)
        return results


# -- process-wide hub ------------------------------------------------------

_hub_lock = threading.Lock()
_default_hub: VerifyHub | None = None
_refs = 0


def acquire_hub(**kwargs) -> VerifyHub:
    """Refcounted access to the process-wide hub (node lifecycle). The
    first acquirer's config wins (device included); in-process
    multi-node tests share one hub on purpose."""
    global _default_hub, _refs
    with _hub_lock:
        if _default_hub is None or not _default_hub.is_running:
            _default_hub = VerifyHub(**kwargs)
            _default_hub.start()
            logger.info(
                "verify hub started on %s (max_batch=%d window=%.1fms cache=%d%s)",
                _default_hub.device,
                _default_hub.max_batch,
                _default_hub.window_s * 1e3,
                _default_hub.cache_size,
                f" verifyd={_default_hub.verifyd_sock}" if _default_hub.verifyd_sock else "",
            )
        _refs += 1
        return _default_hub


def release_hub() -> None:
    global _default_hub, _refs
    with _hub_lock:
        _refs = max(0, _refs - 1)
        if _refs == 0 and _default_hub is not None:
            _default_hub.stop()
            _default_hub = None


def running_hub() -> VerifyHub | None:
    """The process hub, or None when nothing acquired it (library use,
    unit tests) — callers then verify directly."""
    hub = _default_hub
    return hub if hub is not None and hub.is_running else None


async def averify_one(
    pub_key: PubKey,
    msg: bytes,
    sig: bytes,
    *,
    lane: str = LANE_LIVE,
    trace_ctx=None,
) -> bool:
    """Async single-signature chokepoint (the coroutine-safe sibling of
    `verify_one`): awaits the batched verdict through the running hub,
    or verifies on the host when no hub is up. A hub error propagates."""
    hub = running_hub()
    if hub is None:
        return pub_key.verify_signature(msg, sig)
    return await hub.verify(pub_key, msg, sig, lane=lane, trace_ctx=trace_ctx)


def verify_one(
    pub_key: PubKey, msg: bytes, sig: bytes, *, lane: str = LANE_LIVE
) -> bool:
    """THE single-signature chokepoint (vote intake, proposal checks,
    evidence votes). Routes through the running hub — dedup cache +
    coalescing — and verifies on the host when no hub is up. Unlike the
    reference, a hub error (a failed device batch that this signature
    rode in) propagates instead of being re-verified inline."""
    hub = running_hub()
    if hub is None:
        return pub_key.verify_signature(msg, sig)
    return hub.verify_sync(pub_key, msg, sig, lane=lane)


def aggregate_cache_key(pub_keys: list, msgs: list[bytes], agg_sig: bytes) -> tuple:
    """Verdict-LRU key for one aggregate-commit check (the reference's key,
    verify_hub.py:881)."""
    return (
        "bls-aggregate",
        sha256(
            b"".join(
                len(x).to_bytes(4, "big") + x
                for x in [pk.bytes() for pk in pub_keys] + [bytes(m) for m in msgs]
            )
        ),
        bytes(agg_sig),
    )


def verify_aggregate(
    pub_keys: list, msgs: list[bytes], agg_sig: bytes, *, device=DEFAULT_DEVICE
) -> bool:
    """THE aggregate-commit chokepoint (types/validation routes every
    aggregate `verify_commit*` here): one G2 aggregate signature checked
    against per-signer messages through a single pairing product, on the
    caller's thread and `device` (crypto/batch.bls_aggregate_verify). The
    running hub's verdict LRU answers re-verifications of the same commit
    without pairing again. With a verifyd sidecar configured on the
    running hub, a cache miss ships the check over the socket first (the
    daemon pairs it on its device); a check the sidecar does not answer
    runs here, on `device`."""
    from .batch import bls_aggregate_verify

    dev = resolve(device)
    key = aggregate_cache_key(pub_keys, msgs, agg_sig)
    hub = running_hub()
    if hub is not None:
        hit = hub.cached_verdict(key)
        if hit is not None:
            return hit
        remote = hub._remote("aggregate")
        if remote is not None:
            v = remote.remote_verify_aggregate(pub_keys, msgs, agg_sig)
            if v is not None:
                hub.store_verdict(key, v)
                return v
    ok = bls_aggregate_verify(pub_keys, msgs, agg_sig, dev)
    if hub is not None:
        hub.store_verdict(key, ok)
    return ok
