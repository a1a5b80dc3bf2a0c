"""Mempool interface (reference internal/mempool/mempool.go:30).

The concrete priority mempool lives in mempool/pool.py; `NopMempool` keeps
the block executor testable without one."""

from __future__ import annotations

MEMPOOL_CHANNEL = 0x30


class Mempool:
    async def check_tx(self, tx: bytes, sender: str = "", trace_ctx=None) -> None:
        """Validate a tx against the app and admit it. Raises on rejection.
        `trace_ctx` is an optional libs/trace TraceCtx handed through by
        TxIngress so the admission path tiles end to end."""
        raise NotImplementedError

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        raise NotImplementedError

    def reap_max_txs(self, max_txs: int) -> list[bytes]:
        raise NotImplementedError

    def lock(self):
        """Async context manager held across Commit (reference
        Mempool.Lock/Unlock around app commit, execution.go:245)."""
        raise NotImplementedError

    async def update(
        self,
        height: int,
        txs: list[bytes],
        results: list,
        *,
        recheck: bool = True,
    ) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    async def flush(self) -> None:
        raise NotImplementedError


class _NullLock:
    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False


class NopMempool(Mempool):
    async def check_tx(self, tx, sender="", trace_ctx=None):
        pass

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return []

    def reap_max_txs(self, max_txs):
        return []

    def lock(self):
        return _NullLock()

    async def update(self, height, txs, results, *, recheck=True):
        pass

    def size(self):
        return 0

    def size_bytes(self):
        return 0

    async def flush(self):
        pass
