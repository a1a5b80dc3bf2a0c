"""Batch-verifier dispatch (analog of reference crypto/batch/batch.go:11-31,
and of tendermint_tpu/crypto/batch.py).

`create_batch_verifier(pub_key, device=...)` returns an
`AdaptiveBatchVerifier` for the key types that batch: ed25519 and
sr25519, which share the card's batch equation, and bls12381, which
batches through the pairing kernels. Its `verify` partitions a batch by
scheme:

  * Edwards (ed25519/sr25519): from `MIN_TPU_BATCH` signatures up
    through `kernel_eq` on the device (route "cuda"), below it on the
    host one signature at a time (route "cpu"), where the card's fixed
    cost per call would exceed the host's time for the same signatures;
  * BLS: two or more signatures through the pairing kernels on the
    verifier's device (`bls_pairing.verify_items`, route "cuda"), a lone
    one on the host (route "cpu").

`bls_aggregate_verify` runs one aggregate-commit check as one pairing
item on the device. secp256k1 does not batch (as in the reference);
callers verify it signature by signature.

What the reference has and the port does not: a background probe that
warms the backend and measures the cutoff, a breaker with a host
re-verify on device error, and the opt-in switch (TMTPU_BLS_TPU) in
front of the BLS device path. Here the device is usable as soon as
`device=` resolves; `MIN_TPU_BATCH` stays at its default (32, or
TMTPU_MIN_TPU_BATCH) until `_measure_cutoff(device)` is called; the
verifier's device routes BLS as it routes `kernel_eq`; and a device
error propagates to the caller as a `DeviceError` (the original error is
its `__cause__`). The catch-alls above this layer (the consensus receive
loop, block-sync apply, state-sync restore, the scenario runner) let a
`DeviceError` through where they absorb any other error, and
`device_errors()` counts every one raised in the process, so a harness
can tell a failed card from a lossy link. `CPUBatchVerifier` is the host
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

BLS12381 = "bls12381"
#: key types sharing the Edwards-curve batch equation (one device dispatch)
_EDWARDS = (ED25519, SR25519)
#: key types the adaptive verifier takes (BLS runs the pairing kernels)
_BATCHABLE = _EDWARDS + (BLS12381,)

logger = logging.getLogger("crypto.batch")


class DeviceError(RuntimeError):
    """A verification batch failed on its device: a kernel that did not
    build or launch, operands on the wrong device, a plain twin that
    raised. It carries the original error's message, and the error itself
    as `__cause__`. Callers that absorb errors (drop the message, punish
    the peer, try the next snapshot) re-raise it: a device error is never
    a verdict."""


#: every DeviceError raised in this process: (count, the last one)
_DEVICE_ERRORS: list = [0, None]


def device_errors() -> tuple[int, "DeviceError | None"]:
    """How many DeviceErrors this process has raised, and the last one.
    A harness snapshots the count before a run and re-raises the last
    error if the count moved, wherever in the run it was caught."""
    return _DEVICE_ERRORS[0], _DEVICE_ERRORS[1]


def device_error(err: BaseException, n_items: int) -> DeviceError:
    """Count a failed device batch (`libs.metrics.RESILIENCE`, the
    process log) and wrap it: `raise device_error(e, n) from e`."""
    record_resilience("device_error_batches")
    record_resilience("device_error_sigs", n_items)
    out = DeviceError(str(err))
    _DEVICE_ERRORS[0] += 1
    _DEVICE_ERRORS[1] = out
    return out


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


def warm_backend(device=DEFAULT_DEVICE) -> None:
    """Build and load the kernels for `device` now: the attach
    (crypto/backend_telemetry.py) that the verifyd daemon pays at start,
    before any client needs the card, in place of the reference's
    background probe (`tpu_verifier_available`). A CPU device runs the
    plain versions and loads nothing."""
    dev = resolve(device)
    if dev.type == "cuda":
        from .cuda import _build

        _build.build_all()


def mesh_parallelism(device=DEFAULT_DEVICE) -> int:
    """The number of devices a dispatch from `device` shards over now
    (crypto/cuda/verify._shard_device_count): 1 unless the mesh holds more
    than one device of `device`'s type and sharding is not pinned off.
    The VerifyHub scales its batch capacity and window by it. A CPU
    device never reads CUDA: it sees only logical CPU shards set in
    crypto/cuda/mesh.py."""
    from .cuda.verify import _shard_device_count

    return _shard_device_count(resolve(device))


class AdaptiveBatchVerifier(BatchVerifier):
    """Collects ed25519/sr25519/bls12381 entries and verifies each scheme's
    partition on its own: Edwards by size (`kernel_eq` on `device` from
    MIN_TPU_BATCH signatures up, else the host), BLS through the pairing
    kernels on `device` from two signatures up. A device error is counted
    (`libs.metrics.RESILIENCE`) and raised; nothing re-verifies on the
    host."""

    def __init__(self, device=DEFAULT_DEVICE, *, rand_bytes=None):
        self._device = resolve(device)
        self._rand_bytes = rand_bytes
        self._items: list[tuple[PubKey, bytes, bytes]] = []
        #: where the last verify() ran ("cuda", "cpu", or "mixed" when the
        #: scheme partitions took different routes); the VerifyHub stamps
        #: it on its dispatch spans
        self.last_route = "cpu"
        #: {"devices": [...], "shards": [...]} when the last verify() ran
        #: sharded over the mesh (real signatures per shard); None on one
        #: device and on the host
        self.last_dispatch = None

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.TYPE not in _BATCHABLE:
            raise ValueError(
                f"adaptive batch verifier supports {_BATCHABLE}, got {pub_key.TYPE!r}"
            )
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        items = self._items
        results = [False] * len(items)
        routes = []
        self.last_dispatch = None
        for part, run in ((_EDWARDS, self._verify_edwards), ((BLS12381,), self._verify_bls)):
            idxs = [i for i, it in enumerate(items) if it[0].TYPE in part]
            if not idxs:
                continue
            out, route = run([items[i] for i in idxs])
            for i, ok in zip(idxs, out):
                results[i] = ok
            routes.append(route)
        self.last_route = routes[0] if len(set(routes)) == 1 else ("mixed" if routes else "cpu")
        return all(results) and bool(results), results

    @staticmethod
    def _on_device(run, items) -> tuple[list[bool], str]:
        try:
            return run(items), "cuda"
        except DeviceError:
            raise
        except Exception as e:
            raise device_error(e, len(items)) from e

    def _verify_edwards(self, items) -> tuple[list[bool], str]:
        if len(items) >= MIN_TPU_BATCH:
            from . import backend_telemetry
            from .cuda.verify import last_dispatch_info

            out = self._on_device(
                lambda its: self._run(self._make_device_verifier(), its)[1], items
            )
            self.last_dispatch = last_dispatch_info()
            backend_telemetry.set_active(self._device.type)
            return out
        return self._run(CPUBatchVerifier(), items)[1], "cpu"

    def _verify_bls(self, items) -> tuple[list[bool], str]:
        """The BLS partition (reference batch.py:397): the pairing kernels
        for two or more signatures, host verification for a lone one."""
        if len(items) >= 2:
            return self._on_device(self._run_bls_kernel, items)
        return [pk.verify_signature(msg, sig) for pk, msg, sig in items], "cpu"

    def _run_bls_kernel(self, items) -> list[bool]:
        """Decode and subgroup-check through the bls point caches, then one
        pairing batch; undecodable entries are False without a slot."""
        from . import bls as bls_keys
        from .cuda import bls_pairing

        results = [False] * len(items)
        triples = []
        idxs = []
        for i, (pk, msg, sig) in enumerate(items):
            if len(sig) != bls_keys.SIGNATURE_SIZE:
                continue
            pt = bls_keys.pubkey_point(pk.bytes())
            sp = bls_keys.signature_point(bytes(sig))
            if pt is None or sp is None:
                continue
            triples.append((pt, msg, sp))
            idxs.append(i)
        if triples:
            ok = bls_pairing.verify_items(triples, device=self._device)
            for i, good in zip(idxs, ok):
                results[i] = bool(good)
        return results

    def _make_device_verifier(self) -> BatchVerifier:
        from .cuda.verify import DeviceBatchVerifier

        return DeviceBatchVerifier(self._device, rand_bytes=self._rand_bytes)

    @staticmethod
    def _run(target: BatchVerifier, items) -> tuple[bool, list[bool]]:
        for pk, msg, sig in items:
            target.add(pk, msg, sig)
        return target.verify()


def bls_aggregate_verify(
    pub_keys: list, msgs: list[bytes], agg_sig: bytes, device=DEFAULT_DEVICE
) -> bool:
    """Aggregate-commit verification (reference batch.py:501): the whole
    check is ONE multi-pair pairing-product item, run through the pairing
    kernels on `device`, with the reference's reject surface and its
    bls.STATS counters. Callers outside crypto/ go through
    crypto/verify_hub.verify_aggregate (verdict cache)."""
    from . import bls, bls_math
    from .cuda import bls_pairing

    dev = resolve(device)
    bls.STATS["aggregate_verifies"] += 1
    bls.STATS["aggregate_signers"] += len(pub_keys)
    agg = bls.signature_point(bytes(agg_sig)) if len(agg_sig) == bls.SIGNATURE_SIZE else None
    pts = [
        bls.pubkey_point(pk.bytes()) if getattr(pk, "TYPE", None) == bls.KEY_TYPE else None
        for pk in pub_keys
    ]
    if agg is None or not pts or len(pts) != len(msgs) or any(p is None for p in pts):
        bls.STATS["aggregate_failures"] += 1
        return False
    item = [(bls_math.NEG_G1_GEN, agg)] + list(zip(pts, bls_pairing.hash_to_g2(msgs)))
    try:
        ok = bool(
            bls_pairing.verify_pairs_batch(
                [item],
                pad_to=bls_pairing.bucket_items(1),
                pair_pad=bls_pairing.bucket_pairs(len(item)),
                device=dev,
            )[0]
        )
    except DeviceError:
        raise
    except Exception as e:
        raise device_error(e, len(pub_keys)) from e
    if not ok:
        bls.STATS["aggregate_failures"] += 1
    return ok


def supports_batch_verifier(pub_key: PubKey) -> bool:
    """ed25519 and sr25519 batch through the card's batch equation
    (reference crypto/batch/batch.go:26 — same two types), bls12381
    through the pairing kernels. secp256k1 does not batch (single
    verification)."""
    return pub_key.TYPE in _BATCHABLE


def create_batch_verifier(pub_key: PubKey, device=DEFAULT_DEVICE, *, rand_bytes=None):
    if pub_key.TYPE in _BATCHABLE:
        return AdaptiveBatchVerifier(device, rand_bytes=rand_bytes)
    raise ValueError(f"key type {pub_key.TYPE!r} does not support batch verification")
