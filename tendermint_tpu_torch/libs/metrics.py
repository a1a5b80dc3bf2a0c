"""Metrics — the part of tendermint_tpu/libs/metrics.py that the VerifyHub,
crypto/batch.py and the consensus WAL use: the `Histogram` behind the
hub's queue-latency series, the process-wide resilience counters and the
WAL's storage counters.

The reference's resilience counters record batches re-verified on the
host after a device error (its breaker and fallback). The port has
neither: a device error propagates to the caller. What it counts instead
is the errors themselves, so an operator can read how often the card
failed a batch. The `NodeMetrics` renderer waits for the subsystems it
reads (mempool, light, statesync, consensus).
"""

from __future__ import annotations


class Histogram:
    """Cumulative-bucket histogram (the reference's, without the
    Prometheus rendering, which waits for `NodeMetrics`)."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count")

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name: str, help_: str = "", buckets=None):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        self._sum += value
        self._count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self._counts[i] += 1
                return
        self._counts[-1] += 1


# -- process-wide resilience events -----------------------------------------

RESILIENCE: dict[str, float] = {
    "device_error_batches": 0.0,  # device batches that raised (and propagated)
    "device_error_sigs": 0.0,  # signatures in those batches
}


def record_resilience(name: str, value: float = 1.0) -> None:
    RESILIENCE[name] = RESILIENCE.get(name, 0.0) + value


# -- process-wide storage events --------------------------------------------

STORAGE: dict[str, float] = {
    "wal_corrupt_records": 0.0,  # corrupt/torn records hit during replay
    "wal_repairs": 0.0,  # WAL files truncated to the last whole record
    "wal_truncated_bytes": 0.0,  # damaged bytes rotated aside by repair
}


def record_storage(name: str, value: float = 1.0) -> None:
    STORAGE[name] = STORAGE.get(name, 0.0) + value
