"""BootFleet — BootD, the snapshot-serving layer, and the verified
backfill (the port's copy of tendermint_tpu/statesync/fleet.py).

A donor asked for the same snapshot by a wave of cold joiners would load
every chunk from the app once per joiner on the consensus event loop,
and a backfilled header would be accepted on hash-chain linkage alone.
BootD closes both gaps:

  * **shared per-snapshot chunk cache**: chunk bytes are loaded from
    the app's snapshot store once and served to every concurrent
    joiner; same-chunk concurrent requests coalesce onto one in-flight
    store read. The cache is entry-bounded and insertion-evicted;

  * **bounded concurrency with explicit busy-shed**: at most
    ``max_sessions`` chunk-loading sessions run at once; an arrival
    beyond that is rejected with busy (``BootDBusyError``, counted as
    shed). On the wire a shed becomes ``ChunkResponse(busy=True)`` —
    backpressure the joiner retries after backoff, not a failure and
    not a "missing". Cache hits and coalesced joins are not sessions and
    never shed;

  * **manifest loop off the consensus hot path**: the served-snapshot
    manifest re-reads ``ListSnapshots`` on an interval (committing new
    snapshots to the serving set, pruning dead ones and their cached
    chunk bytes), so discovery requests are answered from the manifest;

  * **verified backfill** (joining side, `verify_backfill_batch`):
    backfilled commits are signature-verified in one
    `verify_commit_range` call per window on the backfill lane, on the
    caller's device. An ed25519 window goes to the batch router (the
    card from `MIN_TPU_BATCH` signatures, the host below it); a BLS
    committee's aggregate commit costs one pairing product per height
    (K7a and K7b on the card). Hash-chain linkage is still checked
    first.

BootD takes its knobs from `config.BootDConfig` alone: the reference's
TMTPU_BOOTD_* env overrides are not read. `aggregate()` sums the live
BootDs' stats, which `libs.metrics.NodeMetrics` folds into /metrics at
render time. ``boot.*`` trace spans go to the
flight recorder (serve_chunk / backfill_verify / sync).
"""

from __future__ import annotations

import asyncio
import logging
import weakref

from ..abci import types as abci
from ..device import DEFAULT_DEVICE, resolve
from ..libs import trace
from ..libs.metrics import Histogram
from ..libs.service import Service

logger = logging.getLogger("statesync.fleet")

#: time-to-synced buckets: an in-process 4-validator join lands in
#: fractions of a second; a 150-validator mid-chaos join takes minutes
BOOT_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

#: process-wide registry of live BootDs (`aggregate` sums their stats)
_bootds: "weakref.WeakSet[BootD]" = weakref.WeakSet()


def aggregate():
    """(summed stats, folded time-to-synced hist) across live BootDs,
    or (None, None) when none is running."""
    ds = [d for d in _bootds if d.is_running]
    if not ds:
        return None, None
    keys = ds[0].stats.keys()
    s = {k: sum(d.stats[k] for d in ds) for k in keys}
    s["sessions_now"] = float(sum(d.active_sessions for d in ds))
    counts = [0] * (len(BOOT_BUCKETS) + 1)
    total_sum, total_count = 0.0, 0
    for d in ds:
        h = d.time_to_synced
        for j, c in enumerate(h._counts):
            counts[j] += c
        total_sum += h._sum
        total_count += h._count
    return s, (counts, total_sum, total_count)


class BootDBusyError(Exception):
    """Explicit backpressure: every chunk-loading session slot is taken
    — back off and resubmit. The reactor maps this to
    ``ChunkResponse(busy=True)`` on the wire (shed is backpressure, not
    failure: the requesting joiner retries the SAME donor after backoff
    instead of marking the chunk missing); nothing was queued."""


class BootD(Service):
    """The snapshot-serving daemon (module docstring). Owned by a
    StateSyncReactor; every public entry point is async and safe to
    call concurrently."""

    def __init__(
        self,
        app_conns,
        *,
        config=None,
        logger_: logging.Logger | None = None,
    ):
        super().__init__("bootd", logger_ or logger)
        from ..config import BootDConfig

        cfg = config or BootDConfig()
        self.max_sessions = max(1, cfg.max_sessions)
        self.chunk_cache_size = max(0, cfg.chunk_cache)
        self.refresh_s = max(0.05, cfg.refresh_s)
        self.snapshot_interval = max(1, cfg.snapshot_interval)
        self.backfill_batch = max(1, cfg.backfill_batch)
        self.app_conns = app_conns
        self.active_sessions = 0
        #: the serving set — refreshed by the manifest loop, answered
        #: to SnapshotsRequest without an app round-trip
        self._manifest: tuple[abci.Snapshot, ...] = ()
        self._manifest_ready = asyncio.Event()
        #: (height, format, index) -> chunk bytes (bounded,
        #: insertion-evicted)
        self._chunks: dict[tuple[int, int, int], bytes] = {}
        #: same-chunk concurrent loads coalesce onto one store read
        self._inflight: dict[tuple[int, int, int], asyncio.Future] = {}
        self.time_to_synced = Histogram(
            "bootd_time_to_synced_seconds",
            "cold-start to restored-and-backfilled latency per join",
            buckets=BOOT_BUCKETS,
        )
        self.stats = {
            "chunk_requests": 0.0,    # chunk serves requested (incl. shed)
            "chunks_served": 0.0,     # chunk bytes actually handed out
            "chunk_bytes": 0.0,       # bytes served (cache + store)
            "cache_hits": 0.0,        # served from the shared chunk cache
            "cache_misses": 0.0,      # requests that entered a session
            "coalesced": 0.0,         # joined an in-flight same-chunk load
            "sheds": 0.0,             # rejected-with-busy at the session bound
            "store_reads": 0.0,       # LoadSnapshotChunk app round-trips
            "snapshots_served": 0.0,  # discovery answers from the manifest
            "manifest_refreshes": 0.0,
            "pruned_chunks": 0.0,     # cached chunks dropped with their snapshot
            "backfill_heights": 0.0,  # headers signature-verified in backfill
            "backfill_sigs": 0.0,     # signatures covered by those batches
            "backfill_agg_heights": 0.0,  # verified as ONE aggregate pairing
            "backfill_batches": 0.0,  # backfill-lane funnel calls
            "poisoned_rejects": 0.0,  # chunk/snapshot hash mismatches caught
            "synced": 0.0,            # completed joins observed (time_to_synced)
        }
        _bootds.add(self)

    async def on_start(self) -> None:
        self.spawn(self._manifest_loop(), name="bootd.manifest")

    async def on_stop(self) -> None:
        for fut in self._inflight.values():
            if not fut.done():
                fut.cancel()
        self._inflight.clear()

    # -- serving surface -------------------------------------------------

    async def serve_snapshots(self) -> tuple[abci.Snapshot, ...]:
        """The served-snapshot manifest (committed/pruned by the
        refresh loop — never an app round-trip per discovery request).
        Waits for the first refresh so a donor that just started never
        answers "no snapshots" while the loop is warming."""
        if not self._manifest_ready.is_set():
            try:
                await asyncio.wait_for(
                    self._manifest_ready.wait(), self.refresh_s * 2
                )
            except asyncio.TimeoutError:
                pass
        self.stats["snapshots_served"] += 1
        return self._manifest

    async def serve_chunk(self, height: int, format: int, index: int) -> bytes:
        """Chunk bytes for (height, format, index): the shared cache
        answers warm chunks with zero store reads; a cold chunk
        coalesces onto any in-flight same-chunk load or claims a
        bounded session slot (busy-shed beyond ``max_sessions``).
        Returns b"" when the app doesn't hold the chunk (missing)."""
        self.stats["chunk_requests"] += 1
        key = (height, format, index)
        with trace.span("boot", "serve_chunk", height=height, index=index) as sp:
            hit = self._chunks.get(key)
            if hit is not None:
                self.stats["cache_hits"] += 1
                self.stats["chunks_served"] += 1
                self.stats["chunk_bytes"] += len(hit)
                sp.set(outcome="cache_hit")
                return hit
            fut = self._inflight.get(key)
            if fut is not None:
                self.stats["coalesced"] += 1
                chunk = await asyncio.shield(fut)
                self.stats["chunks_served"] += 1
                self.stats["chunk_bytes"] += len(chunk)
                sp.set(outcome="coalesced")
                return chunk
            if self.active_sessions >= self.max_sessions:
                self.stats["sheds"] += 1
                sp.set(outcome="shed")
                raise BootDBusyError(
                    f"bootd busy: {self.active_sessions} chunk sessions in "
                    f"flight (max {self.max_sessions}); back off and resubmit"
                )
            self.stats["cache_misses"] += 1
            fut = asyncio.get_running_loop().create_future()
            self._inflight[key] = fut
            self.active_sessions += 1
            try:
                res = await self.app_conns.snapshot.load_snapshot_chunk(
                    abci.RequestLoadSnapshotChunk(height, format, index)
                )
                self.stats["store_reads"] += 1
                chunk = res.chunk
            except BaseException as e:
                if not fut.done():
                    # coalesced waiters share the failure; shield() above
                    # keeps a cancelled WAITER from killing the load
                    fut.set_exception(
                        e if not isinstance(e, asyncio.CancelledError)
                        else BootDBusyError("bootd chunk load cancelled")
                    )
                fut.exception()  # consumed here; never "never retrieved"
                raise
            else:
                if not fut.done():
                    fut.set_result(chunk)
            finally:
                self.active_sessions -= 1
                if self._inflight.get(key) is fut:
                    del self._inflight[key]
            if chunk and self.chunk_cache_size:
                while len(self._chunks) >= self.chunk_cache_size:
                    self._chunks.pop(next(iter(self._chunks)))
                self._chunks[key] = chunk
            self.stats["chunks_served"] += 1
            self.stats["chunk_bytes"] += len(chunk)
            sp.set(outcome="served", bytes=len(chunk))
            return chunk

    # -- manifest commit/prune loop --------------------------------------

    async def _manifest_loop(self) -> None:
        """Commit newly-taken snapshots to the serving set and prune
        dead ones (plus their cached chunk bytes) on an interval — the
        app takes snapshots on its own commit path; publication and
        cache hygiene happen HERE, off the consensus hot path."""
        while True:
            try:
                await self.refresh_manifest()
            except Exception as e:  # noqa: BLE001 — serving must survive
                self.logger.debug("bootd manifest refresh failed: %r", e)
            self._manifest_ready.set()
            await asyncio.sleep(self.refresh_s)

    async def refresh_manifest(self) -> tuple[abci.Snapshot, ...]:
        res = await self.app_conns.snapshot.list_snapshots()
        manifest = tuple(
            s for s in res.snapshots
            if s.height % self.snapshot_interval == 0
        )
        self._manifest = manifest
        self.stats["manifest_refreshes"] += 1
        live = {(s.height, s.format) for s in manifest}
        dead = [k for k in self._chunks if (k[0], k[1]) not in live]
        for k in dead:
            del self._chunks[k]
        self.stats["pruned_chunks"] += len(dead)
        return manifest

    # -- joining-side accounting -----------------------------------------

    def record_synced(self, seconds: float) -> None:
        """One completed join (restore + verified backfill), observed
        into the time-to-synced histogram."""
        self.stats["synced"] += 1
        self.time_to_synced.observe(seconds)

    # -- introspection ---------------------------------------------------

    def latency_snapshot(self) -> tuple[list[int], float, int]:
        h = self.time_to_synced
        return list(h._counts), h._sum, h._count

    def cache_hit_rate(self) -> float:
        hits = self.stats["cache_hits"]
        total = hits + self.stats["cache_misses"]
        return hits / total if total else 0.0


async def verify_backfill_batch(
    chain_id: str,
    blocks: list,
    *,
    bootd: BootD | None = None,
    device=DEFAULT_DEVICE,
) -> int:
    """Signature-verify a batch of backfilled light blocks on the backfill
    lane, on `device` — one `types.validation.verify_commit_range` call
    for the whole window, inside which a BLS committee's aggregate commit
    costs one pairing product (K7a and K7b on the card) and a per-sig
    committee rides the batch verifier. Runs in a thread (the blocksync
    pattern) so the funnel's sync internals never block the reactor's
    event loop. Returns the number of signatures covered; raises
    `types.validation.InvalidCommitError` (with `failed_index`) on a
    forged commit."""
    from ..types.validation import verify_commit_range

    dev = resolve(device)
    if not blocks:
        return 0
    entries = [
        (
            lb.validators,
            lb.signed_header.commit.block_id,
            lb.height,
            lb.signed_header.commit,
        )
        for lb in blocks
    ]
    n_sigs = sum(
        sum(1 for s in lb.signed_header.commit.signatures if s.is_commit())
        for lb in blocks
    )
    n_agg = sum(
        1 for lb in blocks if lb.signed_header.commit.is_aggregate()
    )
    with trace.span(
        "boot", "backfill_verify", heights=len(blocks), sigs=n_sigs
    ) as sp:
        await asyncio.to_thread(
            verify_commit_range, chain_id, entries, device=dev, lane="backfill"
        )
        sp.set(outcome="verified", aggregate_heights=n_agg)
    if bootd is not None:
        bootd.stats["backfill_heights"] += len(blocks)
        bootd.stats["backfill_sigs"] += n_sigs
        bootd.stats["backfill_agg_heights"] += n_agg
        bootd.stats["backfill_batches"] += 1
    return n_sigs
