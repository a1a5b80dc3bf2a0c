"""Backend-attach telemetry — the part of tendermint_tpu/crypto/
backend_telemetry.py that the verifyd daemon reports
(`VerifyDaemon.telemetry()["backend"]`).

What the counters mean on the card:

  * ``attach_attempts`` / ``attach_failures``: the process's first
    device use — CUDA initialisation plus the loading of the hand-written
    kernels (crypto/cuda/_build.py), built first if they are not on disk.
    One attach a process that owns the card; a process that ships its
    batches to a verifyd daemon attaches nothing;
  * ``compile_cache_hits`` / ``compile_cache_misses``: a kernel library
    loaded from ``build/torch_ext/`` as it was, against one that nvcc
    built in this process (counted per source file in `_build.build_all`);
  * ``ACTIVE["kind"]``: the device type ("cuda", or "cpu" for the
    plain versions) once a batch has run ``kernel_eq`` on it; "none"
    before.

Not ported: the reference's breaker transitions, TPU→CPU fallback
records and degrade events — the port has no breaker and no fallback —
and its attach-latency list, compile times and mesh stores.
`libs.metrics.NodeMetrics` renders what is kept here. Each attach also
lands in the flight recorder as a ``backend.attach`` span.
"""

from __future__ import annotations

import logging

from ..libs import trace

logger = logging.getLogger("crypto.backend_telemetry")

#: counters the daemon's telemetry reports
BACKEND: dict[str, float] = {
    "attach_attempts": 0.0,   # first device uses (success or not)
    "attach_failures": 0.0,   # attempts that raised
    "compile_cache_hits": 0.0,    # kernel libraries found built on disk
    "compile_cache_misses": 0.0,  # kernel libraries nvcc built here
}

#: the device type whose kernels the process's batches last ran on
ACTIVE: dict[str, str] = {"kind": "none"}


def record_attach_attempt(latency_s: float, ok: bool, *, kind: str = "", error: str = "") -> None:
    """One first device use finished (`kind` is the device type)."""
    BACKEND["attach_attempts"] += 1
    if not ok:
        BACKEND["attach_failures"] += 1
    trace.emit(
        "backend", "attach", duration_s=latency_s, ok=ok, kind=kind or "unknown",
        **({"error": error} if error else {}),
    )
    logger.info(
        "backend attach: %s in %.2fs%s", "up" if ok else "FAILED", latency_s,
        f" ({kind})" if kind else (f" ({error})" if error else ""),
    )


def record_compile_cache(hit: bool) -> None:
    BACKEND["compile_cache_hits" if hit else "compile_cache_misses"] += 1


def set_active(kind: str) -> None:
    ACTIVE["kind"] = kind
