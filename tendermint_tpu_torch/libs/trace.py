"""Flight-recorder tracing — the part of tendermint_tpu/libs/trace.py that
the VerifyHub emits into: bounded structured spans in one process-wide
ring.

A *span* is one named interval inside one *trace*: ``(trace_id,
subsystem, name, start, duration, attrs)``. The hub records two kinds:

  * ``hub.dispatch`` — one per dispatched batch (`emit`), with the batch
    size and the route that served it ("cuda": `kernel_eq` on the
    device; "cpu": host verification);
  * ``hub.queue`` / ``hub.execute`` / ``hub.cache_hit`` — per request
    that carries a `TraceCtx` (`record`), timed on that trace's clock.

The BLS pairing path (crypto/cuda/bls_pairing.py) emits its host time
by part, per pairing batch: ``bls.hash_to_curve``, ``bls.prepare_lines``,
``bls.pack`` and ``bls.h2d``. State sync (statesync/) times its steps
with context-manager spans (`span`): ``boot.serve_chunk``,
``boot.backfill_verify`` and ``boot.sync``; the HashHub emits one
``hash.batch`` per wide batch, with its route.

Spans live in the injectable Clock's monotonic domain
(`libs/clock.Clock.monotonic`) and never read the wall clock. Recording
appends one tuple to a `deque(maxlen=N)`: nothing here locks or waits,
and the oldest span drops out when the ring is full. The recorder is on
by default, as the reference's is; ``TMTPU_TRACE=0`` (or
``configure(enabled=False)``) turns it off, and then every call returns
before touching the ring. ``TMTPU_TRACE_RING`` sizes the ring.

Not ported yet: `finish`, the ring's counters and the automatic dumps
on a wedge or a breaker trip (the port has no breaker).
"""

from __future__ import annotations

import itertools
import logging
import os
from collections import deque

from .clock import SYSTEM, Clock

logger = logging.getLogger("libs.trace")

DEFAULT_RING = 4096

#: process-wide id source — a counter, not uuid/random/time
_ids = itertools.count(1)


class TraceCtx:
    """Propagated handle for one end-to-end trace: the id, the clock the
    trace is timed on, the trace's own t0, and a small `marks` dict for
    boundary timestamps shared across pipeline stages (so the tx
    ingress's stage spans tile its root span exactly)."""

    __slots__ = ("trace_id", "t0", "clock", "marks")

    def __init__(self, trace_id: int, t0: float, clock: Clock):
        self.trace_id = trace_id
        self.t0 = t0
        self.clock = clock
        self.marks: dict[str, float] = {}


class Span:
    """One in-progress span (context-manager use only). `set(k=v)`
    attaches attrs mid-flight; an exception leaves its repr as `error`."""

    __slots__ = ("_rec", "subsystem", "name", "_clock", "_t0", "attrs")

    def __init__(self, rec, subsystem, name, clock, attrs):
        self._rec = rec
        self.subsystem = subsystem
        self.name = name
        self._clock = clock
        self._t0 = 0.0
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._t0 = self._clock.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs["error"] = repr(exc)
        self._rec._append(
            0, self.subsystem, self.name, self._t0,
            self._clock.monotonic() - self._t0, self.attrs or None,
        )


class _NopSpan:
    """Shared do-nothing span for disabled tracing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NOP_SPAN = _NopSpan()


class FlightRecorder:
    """Bounded per-process span ring."""

    def __init__(self, *, enabled: bool = True, ring_size: int = DEFAULT_RING):
        self.enabled = enabled
        self.ring_size = max(1, ring_size)
        # (trace_id, subsystem, name, start_s, duration_s, attrs|None)
        self._ring: deque[tuple] = deque(maxlen=self.ring_size)

    def _append(self, trace_id, subsystem, name, start_s, dur_s, attrs) -> None:
        # deque.append with maxlen evicts the oldest atomically under the
        # GIL — safe from the caller's thread and the hub's threads alike
        self._ring.append((trace_id, subsystem, name, start_s, dur_s, attrs))

    def start(self, clock: Clock | None = None) -> TraceCtx | None:
        """Open a new trace; None when disabled (every record call then
        no-ops on the None ctx)."""
        if not self.enabled:
            return None
        clock = clock or SYSTEM
        return TraceCtx(next(_ids), clock.monotonic(), clock)

    def record(
        self,
        ctx: TraceCtx | None,
        subsystem: str,
        name: str,
        start_s: float,
        end_s: float,
        **attrs,
    ) -> None:
        """Record one stage of a trace with explicit boundary timestamps
        (taken from the ctx's clock by the caller)."""
        if ctx is None or not self.enabled:
            return
        self._append(
            ctx.trace_id, subsystem, name, start_s, end_s - start_s, attrs or None
        )

    def span(self, subsystem: str, name: str, *, clock: Clock | None = None, **attrs):
        """Context-manager span for a code block, outside any trace,
        timed on `clock` (default SYSTEM)."""
        if not self.enabled:
            return NOP_SPAN
        return Span(self, subsystem, name, clock or SYSTEM, attrs)

    def emit(
        self,
        subsystem: str,
        name: str,
        *,
        duration_s: float = 0.0,
        clock: Clock | None = None,
        **attrs,
    ) -> None:
        """A span of the given duration ending now, outside any trace."""
        if not self.enabled:
            return
        now = (clock or SYSTEM).monotonic()
        self._append(0, subsystem, name, now - duration_s, duration_s, attrs or None)

    def dump(self, *, subsystem: str | None = None, trace_id: int | None = None) -> list[dict]:
        """The ring's spans (oldest first) as JSON-ready dicts, optionally
        filtered by subsystem or trace id."""
        out = []
        for tid, sub, name, start, dur, attrs in list(self._ring):
            if subsystem is not None and sub != subsystem:
                continue
            if trace_id is not None and tid != trace_id:
                continue
            d = {
                "trace_id": tid,
                "subsystem": sub,
                "name": name,
                "start_s": round(start, 6),
                "duration_ms": round(dur * 1e3, 4),
            }
            if attrs:
                d["attrs"] = attrs
            out.append(d)
        return out

    def clear(self) -> None:
        self._ring.clear()


def _env_enabled(default: bool) -> bool:
    v = os.environ.get("TMTPU_TRACE")
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false", "no")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        # a malformed diagnostics knob must not kill the process
        logger.warning("ignoring malformed %s=%r (want an int)", name, v)
        return default


#: THE process recorder; module import reads the env.
RECORDER = FlightRecorder(
    enabled=_env_enabled(True),
    ring_size=_env_int("TMTPU_TRACE_RING", DEFAULT_RING),
)


def configure(enabled: bool) -> FlightRecorder:
    """Turn the process recorder on or off. The env wins over the
    caller: TMTPU_TRACE=0 silences it whatever the caller asks."""
    RECORDER.enabled = _env_enabled(enabled)
    return RECORDER


# -- module-level conveniences (the names call sites import) ---------------


def is_enabled() -> bool:
    return RECORDER.enabled


def start(clock: Clock | None = None) -> TraceCtx | None:
    return RECORDER.start(clock)


def record(ctx, subsystem, name, start_s, end_s, **attrs) -> None:
    RECORDER.record(ctx, subsystem, name, start_s, end_s, **attrs)


def span(subsystem, name, *, clock=None, **attrs):
    return RECORDER.span(subsystem, name, clock=clock, **attrs)


def emit(subsystem, name, *, duration_s=0.0, clock=None, **attrs) -> None:
    RECORDER.emit(subsystem, name, duration_s=duration_s, clock=clock, **attrs)
