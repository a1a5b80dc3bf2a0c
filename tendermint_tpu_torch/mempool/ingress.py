"""TxIngress — the production front door for transactions (the port's
copy of tendermint_tpu/mempool/ingress.py).

Raw tx bytes (RPC ``broadcast_tx_*`` and p2p gossip alike) become
admitted mempool entries through a staged pipeline, so a tx flood from
millions of users degrades into *measured shedding* instead of
unbounded buffering or per-tx event-loop stalls:

  stage 0 (``submit_nowait``, synchronous): cheap guards — size cap,
      dedup against the mempool tx cache, the committed-tx LRU, and the
      ingress's own in-flight set (a gossip re-submission records the
      extra source peer and costs nothing) — then a bounded occupancy
      check. A full pipeline REJECTS WITH BUSY (``IngressBusyError``,
      counted as shed) — explicit backpressure, never an unbounded
      queue.

  stage A (``verify_workers`` concurrent tasks): envelope parse +
      signature pre-verification. A *signed tx envelope*
      (``TxEnvelope``, prefix ``stx1``) carries (key type, pubkey,
      nonce, payload, signature); its signature is awaited through the
      VerifyHub's **backfill lane** (``crypto.verify_hub.averify_one``)
      so a tx flood fills device-sized micro-batches without ever
      displacing consensus votes from the live lane, and the hub's
      verdict cache answers gossip re-submissions before they cost a
      dispatch. Bare (non-envelope) txs skip straight through.

  stage B (single releaser, strictly ordered): verdicts flow through a
      sequence-numbered REORDER BUFFER and are admitted in arrival
      order — same-seed flood runs produce bit-identical admitted-tx
      order no matter how the hub's threads interleave. Envelope txs
      then pass their per-sender **nonce lane**: in-order admission per
      sender; an out-of-order nonce PARKS (bounded lane depth, rejected
      busy beyond it) until the gap fills or the park times out on the
      injected clock's wall domain (deterministic under a frozen
      ``ManualClock``); a nonce below the lane watermark is rejected
      stale. Finally the existing ``PriorityMempool.check_tx`` runs the
      ABCI round-trip and fee/priority insert-or-evict under the pool
      lock.

Which device a node's ingress verifies on: stage A goes through the
process's running VerifyHub (`verify_hub.running_hub()`), so an
envelope's signature verifies wherever that hub's dispatch runs. In a
node whose hub is on the card, a dispatch of at least
`batch.MIN_TPU_BATCH` signatures runs `kernel_eq` on the card and a
smaller one runs on the host, as the router says; with a verifyd route
configured, the daemon's hub decides. With no hub running, each
envelope verifies on its own on the host (`averify_one`'s host path: a
lone signature, which the router sends to the host at any cutoff).
Unlike the reference, a hub error is not re-verified on the host: the
tx is rejected ("envelope verify failed").

Tracing: each submission opens a trace on the injected clock; the five
stages — ``intake`` → ``verify`` → ``nonce_lane`` → ``checktx`` →
``insert`` — share boundary marks and TILE the root ``admit`` span
exactly (subsystem ``mempool.ingress``, on the libs/trace flight
recorder).

Config: `config.MempoolIngressConfig`; the env mirrors
TMTPU_INGRESS_DEPTH / _WORKERS / _LANE_DEPTH / _PARK_MS /
_CHECKTX_BATCH win over it, read as the reference reads them
(TMTPU_INGRESS_DISABLE is the node's, read in `Node.on_start`).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import weakref
from collections import OrderedDict
from dataclasses import dataclass

from ..config import MempoolIngressConfig
from ..crypto import pubkey_from_type_and_bytes
from ..crypto import verify_hub as vh
from ..crypto.hash_hub import sha256_one
from ..libs import protoenc as pe
from ..libs import trace
from ..libs.clock import SYSTEM, Clock
from ..libs.metrics import Histogram
from ..libs.service import Service
from .pool import PriorityMempool, TxInCacheError, TxRejectedError

#: admission-latency buckets: sub-ms through flood-saturation tails
ADMIT_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

#: per-sender nonce lanes kept; the least-recently-touched lane (and
#: anything still parked in it) is evicted beyond this
MAX_LANES = 8192

#: process-wide registry of live ingresses; `aggregate()` sums their
#: stats (`libs.metrics.NodeMetrics` folds them at render time)
_ingresses: "weakref.WeakSet[TxIngress]" = weakref.WeakSet()


def aggregate():
    """(summed stats, admit hist, verify hist) across live ingresses,
    or (None, None, None) when none is running."""
    ins = [i for i in _ingresses if i.is_running]
    if not ins:
        return None, None, None
    keys = ins[0].stats.keys()
    s = {k: sum(i.stats[k] for i in ins) for k in keys}
    s["depth"] = float(sum(i.occupancy for i in ins))
    # "parked" in stats is the cumulative park counter; this gauge is
    # how many txs sit parked right now
    s["parked_now"] = float(sum(i.parked_count() for i in ins))

    def fold(hists):
        counts = [0] * (len(ADMIT_BUCKETS) + 1)
        total_sum, total_count = 0.0, 0
        for h in hists:
            for j, c in enumerate(h._counts):
                counts[j] += c
            total_sum += h._sum
            total_count += h._count
        return counts, total_sum, total_count

    return (
        s,
        fold([i.admit_latency for i in ins]),
        fold([i.verify_latency for i in ins]),
    )


class IngressBusyError(ValueError):
    """Explicit backpressure: the intake pipeline (or a nonce lane) is
    full — resubmit later. RPC maps this to a busy response; gossip
    just drops (the peer will re-offer)."""


def _fail(fut: asyncio.Future, err: Exception) -> asyncio.Future:
    """Resolve a fresh future with a rejection, pre-retrieving the
    exception so fire-and-forget callers (gossip) never leak an
    'exception was never retrieved' warning."""
    fut.set_exception(err)
    fut.exception()
    return fut


# -- signed tx envelope -----------------------------------------------------

ENVELOPE_PREFIX = b"stx1"
#: domain separator for envelope signatures — an envelope signature can
#: never double as a vote/proposal/handshake signature
SIGN_DOMAIN = b"tmtpu/tx/v1\x00"


@dataclass(frozen=True)
class TxEnvelope:
    """Parsed signed tx envelope: (key_type, pubkey, nonce, payload,
    signature over SIGN_DOMAIN + nonce + payload)."""

    key_type: str
    pub_key_bytes: bytes
    nonce: int
    payload: bytes
    signature: bytes

    def sign_bytes(self) -> bytes:
        return SIGN_DOMAIN + pe.uvarint(self.nonce) + self.payload

    def pub_key(self):
        return pubkey_from_type_and_bytes(self.key_type, self.pub_key_bytes)

    @property
    def sender(self) -> bytes:
        return self.pub_key_bytes


def encode_envelope(env: TxEnvelope) -> bytes:
    return (
        ENVELOPE_PREFIX
        + pe.string_field(1, env.key_type)
        + pe.bytes_field(2, env.pub_key_bytes)
        + pe.varint_field(3, env.nonce)
        + pe.bytes_field(4, env.payload)
        + pe.bytes_field(5, env.signature)
    )


def make_signed_tx(priv_key, nonce: int, payload: bytes) -> bytes:
    """Build one signed envelope tx (tests / bench / client SDKs)."""
    env = TxEnvelope(
        key_type=priv_key.TYPE,
        pub_key_bytes=priv_key.pub_key().bytes(),
        nonce=nonce,
        payload=payload,
        signature=b"",
    )
    sig = priv_key.sign(env.sign_bytes())
    return encode_envelope(
        TxEnvelope(env.key_type, env.pub_key_bytes, nonce, payload, sig)
    )


def decode_envelope(tx: bytes) -> TxEnvelope | None:
    """Parse a signed envelope; None for bare txs (no prefix); raises
    ValueError when the prefix is present but the body is malformed."""
    if not tx.startswith(ENVELOPE_PREFIX):
        return None
    r = pe.Reader(tx[len(ENVELOPE_PREFIX):])
    # proto3 semantics: an absent varint field means 0 (nonce 0 is the
    # first nonce of a fresh sender, not a malformed envelope)
    key_type, pub, nonce, payload, sig = "", b"", 0, b"", b""
    try:
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                key_type = r.read_string()
            elif f == 2:
                pub = r.read_bytes()
            elif f == 3:
                nonce = r.read_uvarint()
            elif f == 4:
                payload = r.read_bytes()
            elif f == 5:
                sig = r.read_bytes()
            else:
                r.skip(wt)
    except Exception as e:  # noqa: BLE001 — truncated/garbage body
        raise ValueError(f"malformed tx envelope: {e!r}") from None
    if not key_type or not pub or not sig:
        raise ValueError("malformed tx envelope: missing fields")
    return TxEnvelope(key_type, pub, nonce, payload, sig)


# -- pipeline entries -------------------------------------------------------


class _TxEntry:
    __slots__ = (
        "seq", "tx", "hash", "source", "fut", "ctx", "envelope", "error",
        "t_submit", "t_pickup", "t_verified", "extra_sources", "precheck",
    )

    def __init__(self, seq, tx, hash_, source, fut, ctx, t_submit):
        self.seq = seq
        self.tx = tx
        self.hash = hash_
        self.source = source
        self.fut = fut
        self.ctx = ctx  # TraceCtx | None
        self.envelope: TxEnvelope | None = None
        self.error: Exception | None = None  # stage-A verdict
        self.t_submit = t_submit
        self.t_pickup = 0.0
        self.t_verified = 0.0
        self.extra_sources: list[str] = []
        # prefetched ABCI CheckTx response (stage-B slice micro-batch);
        # consumed by PriorityMempool.check_tx in release order
        self.precheck = None


class _NonceLane:
    """Per-sender admission lane: `next` is the watermark (None until
    the first admitted nonce); `parked` holds out-of-order arrivals
    keyed by nonce with their park deadlines (clock wall domain)."""

    __slots__ = ("next", "parked")

    def __init__(self):
        self.next: int | None = None
        self.parked: OrderedDict[int, tuple[_TxEntry, int]] = OrderedDict()


class TxIngress(Service):
    """Staged tx-admission pipeline in front of one PriorityMempool
    (see module docstring)."""

    def __init__(
        self,
        config: MempoolIngressConfig,
        mempool: PriorityMempool,
        *,
        clock: Clock | None = None,
        logger: logging.Logger | None = None,
    ):
        super().__init__("tx-ingress", logger or logging.getLogger("mempool.ingress"))

        def _knob(env_name, explicit, cast):
            v = os.environ.get(env_name)
            return cast(v) if v else explicit

        self.config = config
        self.depth = max(1, _knob("TMTPU_INGRESS_DEPTH", config.depth, int))
        self.verify_workers = max(
            1, _knob("TMTPU_INGRESS_WORKERS", config.verify_workers, int)
        )
        self.lane_depth = max(
            1, _knob("TMTPU_INGRESS_LANE_DEPTH", config.nonce_lane_depth, int)
        )
        self.park_timeout_ns = int(
            max(0.0, _knob("TMTPU_INGRESS_PARK_MS", config.nonce_park_timeout_ms, float))
            * 1e6
        )
        self.checktx_batch = max(
            1, _knob("TMTPU_INGRESS_CHECKTX_BATCH", config.checktx_batch, int)
        )
        self.mempool = mempool
        self.clock = clock or SYSTEM

        self._seq = itertools.count()
        self._intake: asyncio.Queue[_TxEntry] = asyncio.Queue(self.depth)
        self.occupancy = 0  # accepted-submit → resolved-or-parked
        self._pending: dict[bytes, _TxEntry] = {}  # hash → in-pipeline entry
        self._reorder: dict[int, _TxEntry] = {}
        self._next_release = 0
        self._release_ev = asyncio.Event()
        self._lanes: OrderedDict[bytes, _NonceLane] = OrderedDict()
        # senders whose lane currently holds parked entries: expiry runs
        # per release and must be O(parked lanes), not O(all lanes)
        self._parked_lanes: set[bytes] = set()
        # global parked-tx count: parked entries leave the occupancy
        # bound (they must not block live admission), so without this
        # cap an attacker minting fresh senders could hold up to
        # MAX_LANES * lane_depth full txs — the total parked set is
        # bounded by `depth` too (pipeline holds <= depth in flight
        # PLUS <= depth parked)
        self._parked_total = 0
        # serializes lane mutation between the releaser (_admit) and the
        # periodic sweeper (_expire_parked): both await CheckTx mid-
        # lane-update, and an interleaving could regress a watermark and
        # re-admit a nonce — the one property lanes exist to rule out
        self._lane_lock = asyncio.Lock()

        self.admit_latency = Histogram(
            "ingress_admit_latency_seconds",
            "submit-to-insert latency per admitted tx",
            buckets=ADMIT_BUCKETS,
        )
        self.verify_latency = Histogram(
            "ingress_verify_latency_seconds",
            "stage-A parse + signature pre-verify latency per tx",
            buckets=ADMIT_BUCKETS,
        )
        self.stats: dict[str, float] = {
            "submitted": 0.0,     # accepted into the pipeline
            "shed": 0.0,          # rejected busy at intake (backpressure)
            "dedup_drops": 0.0,   # duplicates dropped before any work
            "rejected": 0.0,      # size/malformed/bad-sig/stale/expired
            "sig_failed": 0.0,    # envelope signature pre-verify failures
            "parked": 0.0,        # nonce-gap arrivals parked in a lane
            "park_expired": 0.0,  # parked txs evicted on gap timeout
            "park_adopted": 0.0,  # fresh-lane parks adopted as lane start
            "stale_nonce": 0.0,   # nonce below the lane watermark
            "lane_full": 0.0,     # rejected busy: lane park depth reached
        }
        _ingresses.add(self)

    # -- lifecycle -------------------------------------------------------

    async def on_start(self) -> None:
        for i in range(self.verify_workers):
            self.spawn(self._verify_worker(), name=f"ingress.verify.{i}")
        self.spawn(self._releaser(), name="ingress.release")
        self.spawn(self._park_sweeper(), name="ingress.sweep")

    async def on_stop(self) -> None:
        # resolve everything still pending so no submitter hangs; the
        # pipeline tasks are cancelled by Service.stop after this
        err = IngressBusyError("tx ingress shutting down")
        for entry in list(self._pending.values()):
            self._resolve(entry, err, count=None)
        self._reorder.clear()
        self._lanes.clear()
        self._parked_lanes.clear()
        self._parked_total = 0

    # -- submission ------------------------------------------------------

    def submit_nowait(self, tx: bytes, source: str = "") -> asyncio.Future:
        """Enqueue one tx; the returned future resolves (None) when the
        tx is inserted into the mempool, or raises the rejection
        (awaiting the future IS the synchronous-submit API). A full
        pipeline fails fast with IngressBusyError — the backpressure
        edge — instead of buffering unboundedly."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if not self.is_running:
            # a submission racing shutdown must fail fast: entries
            # accepted with no workers would hang their futures forever
            return _fail(fut, IngressBusyError("tx ingress not running"))
        if len(tx) > self.mempool.config.max_tx_bytes:
            self.stats["rejected"] += 1
            return _fail(fut, TxRejectedError(0, f"tx too large ({len(tx)} bytes)"))
        h = sha256_one(tx)
        pending = self._pending.get(h)
        if pending is not None:
            # already in the pipeline: remember the extra source so the
            # reactor never echoes the tx back to it, drop the duplicate
            if source and source != pending.source:
                pending.extra_sources.append(source)
            self.stats["dedup_drops"] += 1
            return _fail(fut, TxInCacheError("tx already in ingress pipeline"))
        if self.mempool.cache.has(tx) or self.mempool.has_tx(h):
            if source:
                self.mempool.note_peer(h, source)
            self.stats["dedup_drops"] += 1
            return _fail(fut, TxInCacheError("tx already in cache"))
        if self.mempool.is_committed(tx):
            # the committed LRU outlives tx-cache churn under flood: a
            # gossip echo of a committed tx must not cost a pipeline
            # slot + signature verify just to die at the ABCI boundary
            self.stats["dedup_drops"] += 1
            return _fail(fut, TxInCacheError("tx already committed"))
        if self.occupancy >= self.depth:
            self.stats["shed"] += 1
            return _fail(
                fut,
                IngressBusyError(
                    f"ingress busy: {self.occupancy}/{self.depth} in flight"
                ),
            )
        ctx = trace.start(self.clock)
        # t_submit IS the root span's t0 when tracing: the five stage
        # spans share boundary marks and must tile `admit` exactly
        entry = _TxEntry(
            next(self._seq), tx, h, source, fut,
            ctx, ctx.t0 if ctx is not None else self.clock.monotonic(),
        )
        self.occupancy += 1
        self.stats["submitted"] += 1
        self._pending[h] = entry
        # cannot overflow: occupancy ≤ depth bounds queue residency too
        self._intake.put_nowait(entry)
        return fut

    # -- stage A: parse + signature pre-verify ---------------------------

    async def _verify_worker(self) -> None:
        while True:
            entry = await self._intake.get()
            entry.t_pickup = self.clock.monotonic()
            trace.record(
                entry.ctx, "mempool.ingress", "intake",
                entry.t_submit, entry.t_pickup,
            )
            try:
                env = decode_envelope(entry.tx)
                if env is not None:
                    entry.envelope = env
                    ok = await vh.averify_one(
                        env.pub_key(), env.sign_bytes(), env.signature,
                        lane=vh.LANE_BACKFILL, trace_ctx=entry.ctx,
                    )
                    if not ok:
                        entry.error = TxRejectedError(1, "invalid envelope signature")
                        self.stats["sig_failed"] += 1
            except asyncio.CancelledError:
                raise
            except ValueError as e:
                entry.error = TxRejectedError(1, str(e))
            except Exception as e:  # noqa: BLE001 — unknown key type etc.
                entry.error = TxRejectedError(1, f"envelope verify failed: {e!r}")
            entry.t_verified = self.clock.monotonic()
            self.verify_latency.observe(entry.t_verified - entry.t_pickup)
            trace.record(
                entry.ctx, "mempool.ingress", "verify",
                entry.t_pickup, entry.t_verified,
                signed=entry.envelope is not None,
            )
            self._reorder[entry.seq] = entry
            self._release_ev.set()

    # -- stage B: in-order release → nonce lane → checktx/insert ---------

    async def _releaser(self) -> None:
        """Single releaser: admissions happen strictly in release order.
        With checktx_batch > 1, consecutive ready entries form a SLICE
        whose ABCI CheckTx calls are prefetched concurrently (the
        mempool `_recheck` shape) before the serial in-order admission
        consumes them — the per-tx ABCI round-trip cost collapses to
        one RTT per slice on remote-socket apps, while insert order,
        nonce-lane semantics, and same-seed bit-reproducibility are
        untouched (width 1 is byte-for-byte today's serial path,
        asserted in tests)."""
        while True:
            while self._next_release not in self._reorder:
                self._release_ev.clear()
                await self._release_ev.wait()
            entries = [self._reorder.pop(self._next_release)]
            self._next_release += 1
            while (
                len(entries) < self.checktx_batch
                and self._next_release in self._reorder
            ):
                entries.append(self._reorder.pop(self._next_release))
                self._next_release += 1
            if len(entries) > 1:
                await self._prefetch_checktx(entries)
            for entry in entries:
                await self._expire_parked()
                await self._admit(entry)

    async def _prefetch_checktx(self, entries: list[_TxEntry]) -> None:
        """Issue the slice's ABCI CheckTx calls concurrently and stash
        the responses on the entries. Only entries the serial path will
        plausibly admit prefetch: errored stage-A entries never reach
        CheckTx, and `_would_skip_checktx` filters the doomed/parking
        cases (stale nonce, out-of-order park, cache duplicate) so a
        flood of rejects doesn't translate into wasted app round-trips
        — the filter is a HEURISTIC (lane state can shift while the
        slice admits); a wrong skip just means one inline RTT later,
        never a wrong verdict. A prefetch failure likewise leaves
        `precheck` unset and the serial path re-issues inline.
        Staleness note: a commit landing mid-slice can make a
        prefetched verdict stale, the exact window `_recheck` already
        accepts; the committed-tx re-check under the pool lock still
        prevents resurrection."""

        async def fetch(entry: _TxEntry):
            try:
                entry.precheck = await self.mempool.precheck(entry.tx)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — serial path re-issues
                entry.precheck = None

        await asyncio.gather(
            *(
                fetch(e)
                for e in entries
                if e.error is None and not self._would_skip_checktx(e)
            )
        )

    def _would_skip_checktx(self, entry: _TxEntry) -> bool:
        """Best-effort predictor of 'this entry never reaches CheckTx in
        serial admission': cache/committed duplicates reject at the
        pool, nonce-laned entries that are stale or out-of-order reject
        or park (and parked entries drop their prefetch anyway)."""
        if self.mempool.is_committed(entry.tx) or self.mempool.cache.has(entry.tx):
            return True
        env = entry.envelope
        if env is None:
            return False
        lane = self._lanes.get(env.sender)
        nxt = lane.next if lane is not None else None
        if nxt is None:
            return env.nonce != 0  # fresh lane parks any nonzero nonce
        return env.nonce != nxt  # stale (reject) or gap (park) alike

    async def _admit(self, entry: _TxEntry) -> None:
        if entry.error is not None:
            self.stats["rejected"] += 1
            self._finish_trace(entry, outcome="rejected")
            self._resolve(entry, entry.error)
            return
        env = entry.envelope
        if env is None:
            await self._check_and_insert(entry)
            return
        async with self._lane_lock:
            await self._admit_laned(entry, env)

    async def _admit_laned(self, entry: _TxEntry, env: TxEnvelope) -> None:
        lane = self._lanes.get(env.sender)
        if lane is None:
            lane = self._lanes[env.sender] = _NonceLane()
            self._evict_excess_lanes()
        else:
            self._lanes.move_to_end(env.sender)
        if lane.next is not None and env.nonce < lane.next:
            self.stats["stale_nonce"] += 1
            self.stats["rejected"] += 1
            self._finish_trace(entry, outcome="stale_nonce")
            self._resolve(
                entry,
                TxRejectedError(
                    1, f"stale nonce {env.nonce} (lane watermark {lane.next})"
                ),
            )
            return
        if (lane.next is None and env.nonce != 0) or (
            lane.next is not None and env.nonce > lane.next
        ):
            # gap: park (bounded) until the missing nonce admits or the
            # park times out on the injected clock's wall domain. A
            # FRESH lane (no watermark yet) parks any nonzero nonce —
            # gossip may deliver a sender's txs out of order, and
            # admitting nonce k first would reject 0..k-1 as stale
            # forever; on park timeout the lane ADOPTS its lowest parked
            # nonce as the start instead (see _expire_parked).
            if env.nonce in lane.parked:
                self.stats["dedup_drops"] += 1
                self._finish_trace(entry, outcome="dup_nonce")
                self._resolve(
                    entry, TxRejectedError(1, f"nonce {env.nonce} already parked")
                )
                return
            if len(lane.parked) >= self.lane_depth:
                self.stats["lane_full"] += 1
                self._finish_trace(entry, outcome="lane_full")
                self._resolve(
                    entry,
                    IngressBusyError(
                        f"nonce lane full ({len(lane.parked)} parked)"
                    ),
                )
                return
            if self._parked_total >= self.depth:
                # global park capacity: fresh-sender floods must not
                # sidestep the depth bound through the parked set
                self.stats["shed"] += 1
                self._finish_trace(entry, outcome="park_capacity")
                self._resolve(
                    entry,
                    IngressBusyError(
                        f"park capacity exhausted ({self._parked_total} parked)"
                    ),
                )
                return
            # a parked entry admits at an arbitrarily later release:
            # its slice-prefetched CheckTx verdict would be stale by
            # whole blocks — drop it, the drain path re-issues
            entry.precheck = None
            lane.parked[env.nonce] = (
                entry, self.clock.now_ns() + self.park_timeout_ns
            )
            self._parked_lanes.add(env.sender)
            self._parked_total += 1
            self.stats["parked"] += 1
            # the parked tx leaves the bounded pipeline (its own lane
            # depth bounds it now); the future stays pending
            self.occupancy -= 1
            return
        # in order (or the lane's first tx): admit, then drain any
        # parked successors the admission just unblocked
        admitted = await self._check_and_insert(entry)
        if admitted:
            lane.next = env.nonce + 1
            await self._drain_parked(env.sender, lane)

    async def _drain_parked(self, sender: bytes, lane: _NonceLane) -> None:
        while lane.next in lane.parked:
            entry, _deadline = lane.parked.pop(lane.next)
            self._parked_total -= 1
            # a parked entry released its occupancy slot when it parked
            if await self._check_and_insert(entry, holds_slot=False):
                lane.next += 1
            else:
                break  # failed nonce does not advance the watermark
        if not lane.parked:
            self._parked_lanes.discard(sender)

    async def _check_and_insert(
        self, entry: _TxEntry, *, holds_slot: bool = True
    ) -> bool:
        slot = True if holds_slot else None
        t_lane_end = self.clock.monotonic()
        trace.record(
            entry.ctx, "mempool.ingress", "nonce_lane",
            entry.t_verified, t_lane_end,
        )
        if entry.ctx is not None:
            entry.ctx.marks["checktx_start"] = t_lane_end
        pre, entry.precheck = entry.precheck, None  # consume-once
        try:
            await self.mempool.check_tx(
                entry.tx, sender=entry.source, trace_ctx=entry.ctx, pre=pre
            )
        except asyncio.CancelledError:
            raise
        except TxInCacheError as e:
            self.stats["dedup_drops"] += 1
            self._finish_trace(entry, outcome="dup")
            self._resolve(entry, e, count=slot)
            return False
        except ValueError as e:  # TxRejectedError, MempoolFullError
            self._finish_trace(entry, outcome="rejected")
            self._resolve(entry, e, count=slot)
            return False
        except Exception as e:  # noqa: BLE001 — app-conn failures etc.
            # anything else (ABCI socket drop, app crash) must reject
            # THIS tx, never kill the single releaser task — a dead
            # releaser wedges all admission until node restart
            self.logger.warning(
                "checktx errored (%r); rejecting tx %s",
                e, entry.hash.hex()[:12],
            )
            self.stats["rejected"] += 1
            self._finish_trace(entry, outcome="error")
            self._resolve(entry, TxRejectedError(1, f"checktx error: {e!r}"), count=slot)
            return False
        for s in entry.extra_sources:
            self.mempool.note_peer(entry.hash, s)
        end = (
            entry.ctx.marks.get("insert_end") if entry.ctx is not None else None
        )
        self._finish_trace(entry, outcome="admitted", end=end)
        self.admit_latency.observe(self.clock.monotonic() - entry.t_submit)
        self._resolve(entry, None, count=slot)
        return True

    # -- nonce-lane maintenance ------------------------------------------

    async def _expire_parked(self) -> None:
        """Resolve parked txs whose gap never filled inside the park
        timeout: an ESTABLISHED lane evicts them (the missing nonce is
        the sender's problem — all successors are unusable), a FRESH
        lane (watermark never known) instead ADOPTS its lowest parked
        nonce as the lane start and admits from there. Runs at every
        in-order release and from the periodic sweeper; deadlines live
        on the injected clock's wall domain, so a frozen ManualClock
        never expires anything mid-flood and same-seed runs stay
        bit-identical. Scans only lanes that actually hold parked txs
        (the _parked_lanes index), so the per-release call stays O(1)
        for the overwhelmingly common no-gaps flood. Holds the lane
        lock: the sweeper and the releaser must never interleave their
        mid-await lane updates."""
        async with self._lane_lock:
            await self._expire_parked_locked()

    async def _expire_parked_locked(self) -> None:
        now = self.clock.now_ns()
        for sender in list(self._parked_lanes):
            lane = self._lanes.get(sender)
            if lane is None or not lane.parked:
                self._parked_lanes.discard(sender)
                continue
            while lane.parked:
                # arrival order == deadline order (constant park timeout)
                nonce, (entry, deadline) = next(iter(lane.parked.items()))
                if deadline > now:
                    break
                if lane.next is None:
                    # fresh lane timed out waiting for nonce 0: adopt the
                    # lowest parked nonce as the start and drain upward
                    low = min(lane.parked)
                    entry, _deadline = lane.parked.pop(low)
                    self._parked_total -= 1
                    self.stats["park_adopted"] += 1
                    if await self._check_and_insert(entry, holds_slot=False):
                        lane.next = low + 1
                        await self._drain_parked(sender, lane)
                    # loop again: leftovers past a remaining gap now sit
                    # in an established lane and expire by eviction
                    continue
                del lane.parked[nonce]
                self._parked_total -= 1
                self.stats["park_expired"] += 1
                self.stats["rejected"] += 1
                self._finish_trace(entry, outcome="park_expired")
                self._resolve(
                    entry,
                    TxRejectedError(1, f"nonce gap timed out (parked {nonce})"),
                    count=None,  # occupancy was released at park time
                )
            if not lane.parked:
                self._parked_lanes.discard(sender)

    def _evict_excess_lanes(self) -> None:
        while len(self._lanes) > MAX_LANES:
            sender, lane = self._lanes.popitem(last=False)
            self._parked_lanes.discard(sender)
            self._parked_total -= len(lane.parked)
            for entry, _deadline in lane.parked.values():
                # same accounting as a gap timeout: counted rejected and
                # the admit trace closed, so floods of many senders never
                # lose spans or undercount mempool_tx_rejected
                self.stats["park_expired"] += 1
                self.stats["rejected"] += 1
                self._finish_trace(entry, outcome="lane_evicted")
                self._resolve(
                    entry, IngressBusyError("nonce lane evicted"), count=None
                )

    async def _park_sweeper(self) -> None:
        interval = max(0.05, self.park_timeout_ns / 4e9)
        while True:
            await asyncio.sleep(interval)
            await self._expire_parked()

    # -- bookkeeping -----------------------------------------------------

    def _resolve(self, entry: _TxEntry, err, count: bool | None = True) -> None:
        """Terminal outcome for an entry: resolve its future, drop it
        from the pending map, and (unless `count is None`) release its
        occupancy slot."""
        if count is not None:
            self.occupancy = max(0, self.occupancy - 1)
        self._pending.pop(entry.hash, None)
        if entry.fut.done():
            return  # stop() raced a normal resolution
        if err is None:
            entry.fut.set_result(None)
        else:
            entry.fut.set_exception(err)
            # a gossip caller may never await rejection futures; mark
            # the exception retrieved so the loop doesn't log leaks
            entry.fut.exception()

    def _finish_trace(self, entry: _TxEntry, *, outcome: str, end=None) -> None:
        if entry.ctx is None:
            return
        trace.record(
            entry.ctx, "mempool.ingress", "admit",
            entry.ctx.t0,
            end if end is not None else entry.ctx.clock.monotonic(),
            outcome=outcome,
        )

    def parked_count(self) -> int:
        return self._parked_total
