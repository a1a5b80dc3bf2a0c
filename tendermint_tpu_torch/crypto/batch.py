"""Batch-verifier dispatch (analog of reference crypto/batch/batch.go:11-31,
and of tendermint_tpu/crypto/batch.py).

`create_batch_verifier(pub_key, device=...)` returns an
`AdaptiveBatchVerifier` for the key types that batch (ed25519 and
sr25519, which share the card's batch equation). It routes each batch by
size: from `MIN_TPU_BATCH` signatures up through `kernel_eq` on the
device (route "cuda"), below it to the host one signature at a time
(route "cpu"), where the card's fixed cost per call would exceed the
host's time for the same signatures. secp256k1 does not batch (as in the
reference); callers verify it signature by signature.

What the reference has and the port does not: a background probe that
warms the backend and measures the cutoff, and a breaker with a host
re-verify on device error. Here the device is usable as soon as
`device=` resolves; `MIN_TPU_BATCH` stays at its default (32, or
TMTPU_MIN_TPU_BATCH) until `_measure_cutoff(device)` is called; and a
device error propagates to the caller. `CPUBatchVerifier` is the host
floor the device path is measured against.
"""

from __future__ import annotations

import logging
import os

from ..device import DEFAULT_DEVICE, resolve
from ..libs.metrics import record_resilience
from . import BatchVerifier, PubKey
from .ed25519 import KEY_TYPE as ED25519
from .sr25519 import KEY_TYPE as SR25519

#: key types sharing the Edwards-curve batch equation (one device dispatch)
_EDWARDS = (ED25519, SR25519)

logger = logging.getLogger("crypto.batch")


class CPUBatchVerifier(BatchVerifier):
    """Verify each entry independently on the host. Large batches fan out
    over a thread pool — OpenSSL-backed ed25519 verification releases the
    GIL, so this scales with cores. Small batches stay on the calling
    thread."""

    PARALLEL_THRESHOLD = 64

    def __init__(self, *, parallel: bool | None = None):
        self._items: list[tuple[PubKey, bytes, bytes]] = []
        self._parallel = parallel

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        items = self._items
        use_threads = (
            self._parallel
            if self._parallel is not None
            else len(items) >= self.PARALLEL_THRESHOLD
        )
        if use_threads and len(items) > 1:
            results = list(_cpu_pool().map(_verify_one, items, chunksize=16))
        else:
            results = [_verify_one(it) for it in items]
        return all(results) and bool(results), results


def _verify_one(item: tuple[PubKey, bytes, bytes]) -> bool:
    pk, msg, sig = item
    return pk.verify_signature(msg, sig)


_pool = None


def _cpu_pool():
    global _pool
    if _pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _pool = ThreadPoolExecutor(
            max_workers=min(32, os.cpu_count() or 4),
            thread_name_prefix="sigverify",
        )
    return _pool


# Below this many signatures the device's fixed cost per call exceeds
# what the host takes for the same signatures: verify on the host.
# `_measure_cutoff` replaces it with a measured crossover;
# TMTPU_MIN_TPU_BATCH pins it.
MIN_TPU_BATCH = int(os.environ.get("TMTPU_MIN_TPU_BATCH", "32"))


def _measure_cutoff(device=DEFAULT_DEVICE) -> dict | None:
    """Derive MIN_TPU_BATCH from measurement, as the reference does once
    its device is warm: time one device call at the floor bucket (64
    signatures, where the fixed cost dominates) and the parallel host
    verifier on the same signatures, and route to the device from the
    size where its flat call cost beats the host's rate. The first device
    call warms the kernels (they build at first launch) and is not
    timed. Honors TMTPU_MIN_TPU_BATCH as an override (returns None).
    Returns what it measured."""
    global MIN_TPU_BATCH
    if os.environ.get("TMTPU_MIN_TPU_BATCH"):
        return None
    import time

    from .cuda.verify import _MIN_BUCKET, verify_batch_eq
    from .ed25519 import Ed25519PrivKey

    dev = resolve(device)
    priv = Ed25519PrivKey(b"\x42" * 32)
    pub = priv.pub_key()
    items = [
        (pub.bytes(), b"cutoff-probe-%d" % i, priv.sign(b"cutoff-probe-%d" % i))
        for i in range(_MIN_BUCKET)
    ]
    verify_batch_eq(items, dev)  # warm
    t0 = time.perf_counter()
    verify_batch_eq(items, dev)
    device_call_s = time.perf_counter() - t0

    for _ in range(2):  # warm the pool, then measure
        bv = CPUBatchVerifier(parallel=True)
        for _pub, msg, sig in items:
            bv.add(pub, msg, sig)
        t0 = time.perf_counter()
        bv.verify()
        cpu_s = time.perf_counter() - t0
    cpu_rate = len(items) / max(cpu_s, 1e-9)
    measured = int(device_call_s * cpu_rate) + 1
    MIN_TPU_BATCH = max(8, min(2048, measured))
    logger.info(
        "measured device cutoff: device call %.2fms, host %.0f sigs/s -> "
        "MIN_TPU_BATCH=%d",
        device_call_s * 1e3,
        cpu_rate,
        MIN_TPU_BATCH,
    )
    return {
        "device_call_ms": device_call_s * 1e3,
        "host_sigs_per_s": cpu_rate,
        "measured": measured,
        "min_tpu_batch": MIN_TPU_BATCH,
    }


class AdaptiveBatchVerifier(BatchVerifier):
    """Collects ed25519/sr25519 entries and routes the batch by size: to
    `kernel_eq` on `device` from MIN_TPU_BATCH signatures up, else to the
    host. A device error is counted (`libs.metrics.RESILIENCE`) and
    raised; nothing re-verifies on the host. The reference's BLS
    partition waits for the BLS port."""

    def __init__(self, device=DEFAULT_DEVICE, *, rand_bytes=None):
        self._device = resolve(device)
        self._rand_bytes = rand_bytes
        self._items: list[tuple[PubKey, bytes, bytes]] = []
        #: where the last verify() ran ("cuda" or "cpu"); the VerifyHub
        #: stamps it on its dispatch spans
        self.last_route = "cpu"

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.TYPE not in _EDWARDS:
            raise ValueError(
                f"adaptive batch verifier supports {_EDWARDS}, got {pub_key.TYPE!r}"
            )
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        items = self._items
        if items and len(items) >= MIN_TPU_BATCH:
            try:
                out = self._run(self._make_device_verifier(), items)
            except Exception:
                record_resilience("device_error_batches")
                record_resilience("device_error_sigs", len(items))
                raise
            self.last_route = "cuda"
        else:
            out = self._run(CPUBatchVerifier(), items)
            self.last_route = "cpu"
        return out

    def _make_device_verifier(self) -> BatchVerifier:
        from .cuda.verify import DeviceBatchVerifier

        return DeviceBatchVerifier(self._device, rand_bytes=self._rand_bytes)

    @staticmethod
    def _run(target: BatchVerifier, items) -> tuple[bool, list[bool]]:
        for pk, msg, sig in items:
            target.add(pk, msg, sig)
        return target.verify()


def supports_batch_verifier(pub_key: PubKey) -> bool:
    """ed25519 and sr25519 batch through the card's batch equation
    (reference crypto/batch/batch.go:26 — same two types). secp256k1 does
    not batch (single verification)."""
    return pub_key.TYPE in _EDWARDS


def create_batch_verifier(pub_key: PubKey, device=DEFAULT_DEVICE, *, rand_bytes=None):
    if pub_key.TYPE in _EDWARDS:
        return AdaptiveBatchVerifier(device, rand_bytes=rand_bytes)
    raise ValueError(f"key type {pub_key.TYPE!r} does not support batch verification")
