"""Priority mempool (reference internal/mempool/v1/mempool.go:30 — the
default mempool version, config/config.go:852) plus the LRU tx cache
(reference internal/mempool/cache.go); the port's copy of
tendermint_tpu/mempool/pool.py, with no device work of its own (tx
hashes go through the HashHub, whose device route is off unless
switched on).

Transactions are admitted via ABCI CheckTx on the mempool connection and
held in (priority DESC, arrival ASC) order; `reap_max_bytes_max_gas`
takes the highest-priority prefix that fits the block budget, and
`update` removes committed txs and optionally re-CheckTxs the remainder
(reference v1/mempool.go Update/recheckTxs). When full, the lowest-
priority resident tx is evicted if the newcomer outranks it
(v1/mempool.go:232 canAddTx / eviction)."""

from __future__ import annotations

import asyncio
import itertools
import logging
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

from ..abci import types as abci
from ..abci.client import Client
from ..config import MempoolConfig
from ..crypto.hash_hub import sha256_one
from ..libs import trace
from . import Mempool

#: process-wide registry of live pools; `aggregate_pools` sums their
#: stats (`libs.metrics.NodeMetrics` folds them at render time)
_pools: "weakref.WeakSet[PriorityMempool]" = weakref.WeakSet()


def aggregate_pools():
    """Summed (stats, size, bytes) across every live pool, or None."""
    pools = list(_pools)
    if not pools:
        return None
    keys = pools[0].stats.keys()
    s = {k: sum(p.stats[k] for p in pools) for k in keys}
    return s, sum(p.size() for p in pools), sum(p.size_bytes() for p in pools)


class TxCache:
    """Fixed-size LRU of tx hashes (reference mempool/cache.go LRUTxCache)."""

    def __init__(self, size: int):
        self.size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()

    def push(self, tx: bytes) -> bool:
        """Returns False if already present (and refreshes recency)."""
        key = sha256_one(tx)
        if key in self._map:
            self._map.move_to_end(key)
            return False
        self._map[key] = None
        if len(self._map) > self.size:
            self._map.popitem(last=False)
        return True

    def remove(self, tx: bytes) -> None:
        self._map.pop(sha256_one(tx), None)

    def has(self, tx: bytes) -> bool:
        return sha256_one(tx) in self._map

    def reset(self) -> None:
        self._map.clear()


class TxRejectedError(ValueError):
    def __init__(self, code: int, log: str):
        super().__init__(f"tx rejected: code={code} log={log!r}")
        self.code = code
        self.log = log


class TxInCacheError(ValueError):
    pass


class MempoolFullError(ValueError):
    pass


@dataclass
class WrappedTx:
    tx: bytes
    hash: bytes
    height: int  # height at admission
    priority: int
    gas_wanted: int
    sender: str
    seq: int  # arrival order (FIFO tie-break)
    time_ns: int = 0
    peers: set[str] = field(default_factory=set)
    gossiped: int = 0  # peers this tx was sent to (fan-out cap)

    def sort_key(self):
        return (-self.priority, self.seq)


class PriorityMempool(Mempool):
    def __init__(
        self,
        config: MempoolConfig,
        app: Client,
        *,
        height: int = 0,
        logger: logging.Logger | None = None,
    ):
        self.config = config
        self.app = app
        self.height = height
        self.logger = logger or logging.getLogger("mempool")
        self.cache = TxCache(config.cache_size)
        # hashes of txs committed in a block: an admission whose CheckTx
        # was in flight across that commit must NOT resurrect them (the
        # update/check_tx interleaving class — see check_tx)
        self._committed = TxCache(config.cache_size)
        self._txs: dict[bytes, WrappedTx] = {}  # hash -> wtx
        self._bytes = 0
        self._seq = itertools.count()
        self._lock = asyncio.Lock()
        # flood observability, folded into /metrics at render time
        self.stats: dict[str, float] = {
            "admitted": 0.0,   # txs inserted into the resident set
            "rejected": 0.0,   # CheckTx/size rejections (full pool incl.)
            "evicted": 0.0,    # residents displaced by higher priority
            "recheck_failed": 0.0,  # residents dropped by post-commit recheck
        }
        _pools.add(self)
        # set when txs are available; consensus wait-for-txs hook
        self._txs_available: asyncio.Event = asyncio.Event()
        self.notified_txs_available = False
        # pulsed by update() when it resets notified_txs_available, so the
        # consensus txs-available waiter sleeps instead of polling
        self._notified_reset: asyncio.Event = asyncio.Event()

    # -- admission -------------------------------------------------------

    async def precheck(self, tx: bytes):
        """Bare ABCI CheckTx round-trip with NO cache/insert side
        effects — the tx-ingress stage-B slice prefetch (release-order
        micro-batching) issues these concurrently and hands the
        responses back through check_tx(pre=...). Kept on the pool so
        the app connection stays encapsulated."""
        return await self.app.check_tx(abci.RequestCheckTx(tx))

    async def check_tx(
        self, tx: bytes, sender: str = "", trace_ctx=None, pre=None
    ) -> None:
        if len(tx) > self.config.max_tx_bytes:
            self.stats["rejected"] += 1
            raise TxRejectedError(0, f"tx too large ({len(tx)} bytes)")
        if self._committed.has(tx):
            raise TxInCacheError("tx already committed")
        if not self.cache.push(tx):
            # seen before: record the extra gossip sender, reject
            wtx = self._txs.get(sha256_one(tx))
            if wtx is not None and sender:
                wtx.peers.add(sender)
            raise TxInCacheError("tx already in cache")
        # checktx/insert trace stages (TxIngress hands its trace ctx
        # through so the admission path tiles end to end): the checktx
        # span starts at the nonce-lane boundary mark the ingress left,
        # so stage durations share boundaries and sum exactly
        t_ck0 = (
            trace_ctx.marks.pop("checktx_start", trace_ctx.clock.monotonic())
            if trace_ctx is not None
            else 0.0
        )
        # `pre` is a slice-prefetched response (ingress stage-B micro-
        # batching): consume it instead of paying another ABCI RTT
        res = pre if pre is not None else await self.app.check_tx(
            abci.RequestCheckTx(tx)
        )
        if trace_ctx is not None:
            t_ck1 = trace_ctx.clock.monotonic()
            trace.record(trace_ctx, "mempool.ingress", "checktx", t_ck0, t_ck1)
        if not res.is_ok():
            self.stats["rejected"] += 1
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            raise TxRejectedError(res.code, res.log)
        # insert + eviction are one atomic section against update(): the
        # executor commits holding lock(), so an admission whose CheckTx
        # straddled that commit can neither double-count _bytes against a
        # concurrent eviction nor resurrect a tx the commit just removed
        async with self._lock:
            if self._committed.has(tx):
                # committed while our CheckTx round-trip was in flight
                raise TxInCacheError("tx committed during admission")
            wtx = WrappedTx(
                tx=tx,
                hash=sha256_one(tx),
                height=self.height,
                priority=res.priority,
                gas_wanted=res.gas_wanted,
                sender=res.sender or sender,
                seq=next(self._seq),
                # the gossip source already has this tx: never echo it back
                peers={sender} if sender else set(),
            )
            try:
                self._insert(wtx)
            except MempoolFullError:
                self.stats["rejected"] += 1
                raise
            self.stats["admitted"] += 1
            if trace_ctx is not None:
                t_ins = trace_ctx.clock.monotonic()
                trace.record(trace_ctx, "mempool.ingress", "insert", t_ck1, t_ins)
                trace_ctx.marks["insert_end"] = t_ins

    def _insert(self, wtx: WrappedTx) -> None:
        if wtx.hash in self._txs:
            return
        while (
            len(self._txs) >= self.config.size
            or self._bytes + len(wtx.tx) > self.config.max_txs_bytes
        ):
            victim = max(self._txs.values(), key=lambda w: w.sort_key())
            if victim.sort_key() <= wtx.sort_key():
                # newcomer doesn't outrank the worst resident: reject
                self.cache.remove(wtx.tx)
                raise MempoolFullError(
                    f"mempool full ({len(self._txs)} txs, {self._bytes} bytes)"
                )
            self._remove(victim.hash, remove_from_cache=True)
            self.stats["evicted"] += 1
            self.logger.debug("evicted tx %s", victim.hash.hex()[:12])
        self._txs[wtx.hash] = wtx
        self._bytes += len(wtx.tx)
        if not self._txs_available.is_set():
            self._txs_available.set()

    def _remove(self, hash_: bytes, *, remove_from_cache: bool) -> None:
        wtx = self._txs.pop(hash_, None)
        if wtx is None:
            return
        self._bytes -= len(wtx.tx)
        if remove_from_cache:
            self.cache.remove(wtx.tx)

    # -- reaping ---------------------------------------------------------

    def _ordered(self) -> list[WrappedTx]:
        return sorted(self._txs.values(), key=lambda w: w.sort_key())

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        out: list[bytes] = []
        total_bytes = total_gas = 0
        for wtx in self._ordered():
            nb = total_bytes + len(wtx.tx)
            if max_bytes > -1 and nb > max_bytes:
                break
            ng = total_gas + wtx.gas_wanted
            if max_gas > -1 and ng > max_gas:
                break
            total_bytes, total_gas = nb, ng
            out.append(wtx.tx)
        return out

    def reap_max_txs(self, max_txs: int) -> list[bytes]:
        txs = [w.tx for w in self._ordered()]
        return txs if max_txs < 0 else txs[:max_txs]

    # -- lifecycle -------------------------------------------------------

    def lock(self):
        return self._lock

    async def update(
        self, height: int, txs: list[bytes], results: list, *, recheck: bool = True
    ) -> None:
        """Remove committed txs; re-CheckTx what remains (reference
        v1/mempool.go Update). Caller holds lock() (the executor commits
        under it)."""
        self.height = height
        for i, tx in enumerate(txs):
            committed_ok = i < len(results) and results[i].is_ok()
            if committed_ok:
                self.cache.push(tx)  # keep committed txs in cache
                # remember the commit: an admission in flight across this
                # update must not re-insert the tx (check_tx re-checks
                # this under lock after its ABCI round-trip)
                self._committed.push(tx)
            else:
                self.cache.remove(tx)
            self._remove(sha256_one(tx), remove_from_cache=False)
        if recheck and self.config.recheck and self._txs:
            await self._recheck()
        if self.size() > 0:
            self._txs_available.set()
        else:
            self._txs_available.clear()
        self.notified_txs_available = False
        self._notified_reset.set()

    async def _recheck(self) -> None:
        """Re-run CheckTx(RECHECK) on all resident txs after a block
        changed app state (reference recheckTxs v1/mempool.go:540).

        Micro-batched: the resident set is re-checked in concurrent
        slices of `recheck_batch` ABCI calls instead of N sequential
        round-trips, so post-commit recheck latency scales with the
        slowest call per slice, not the sum. Results are applied in
        priority order regardless of completion order (gather preserves
        submission order), so the surviving set is deterministic."""
        entries = self._ordered()
        width = max(1, self.config.recheck_batch)
        for i in range(0, len(entries), width):
            chunk = entries[i : i + width]
            results = await asyncio.gather(
                *(
                    self.app.check_tx(
                        abci.RequestCheckTx(w.tx, abci.CheckTxType.RECHECK)
                    )
                    for w in chunk
                )
            )
            for wtx, res in zip(chunk, results):
                if wtx.hash not in self._txs:
                    continue  # displaced while the slice was in flight
                if not res.is_ok():
                    self._remove(
                        wtx.hash,
                        remove_from_cache=not self.config.keep_invalid_txs_in_cache,
                    )
                    self.stats["recheck_failed"] += 1
                else:
                    wtx.priority = res.priority

    def size(self) -> int:
        return len(self._txs)

    def size_bytes(self) -> int:
        return self._bytes

    async def flush(self) -> None:
        self._txs.clear()
        self._bytes = 0
        self.cache.reset()

    # -- gossip support --------------------------------------------------

    def all_entries(self) -> list[WrappedTx]:
        return self._ordered()

    def has_tx(self, hash_: bytes) -> bool:
        return hash_ in self._txs

    def close(self) -> None:
        """Deregister from the process-wide metrics fold: a stopped
        node's pool must not keep contributing residents to /metrics
        (the ingress registry filters on is_running; pools are not
        Services, so owners call this from their stop path)."""
        _pools.discard(self)

    def is_committed(self, tx: bytes) -> bool:
        """True when `tx` was committed in a recent block (bounded LRU):
        admission layers reject these before any verify/ABCI work."""
        return self._committed.has(tx)

    def note_peer(self, hash_: bytes, peer: str) -> None:
        """Record that `peer` already has this tx (gossip duplicate):
        the broadcast loop will never echo it back there."""
        wtx = self._txs.get(hash_)
        if wtx is not None and peer:
            wtx.peers.add(peer)

    async def wait_for_txs(self) -> None:
        await self._txs_available.wait()

    async def wait_notified_reset(self) -> None:
        """Block until the next post-commit reset of the once-per-height
        txs-available notification latch."""
        self._notified_reset.clear()
        await self._notified_reset.wait()
