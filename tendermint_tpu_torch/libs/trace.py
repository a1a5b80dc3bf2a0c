"""Flight-recorder tracing — bounded structured spans in one process-wide
ring (the port's copy of tendermint_tpu/libs/trace.py, whole).

A *span* is one named interval inside one *trace*: ``(trace_id, parent,
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
and the oldest span drops out when the ring is full (``recorded`` and
``dropped`` count them). The recorder is on by default;
``TMTPU_TRACE=0`` (or ``configure(enabled=False)``) turns it off, and
then every call returns before touching the ring.

A node applies its ``[trace]`` section once per process
(`configure_once`, from `Node.on_start`); `auto_dump(reason)` writes the
ring to ``out_dir`` (``TMTPU_TRACE_DIR`` wins over the config) and keeps
a bounded list of dumps. The port has no breaker, so nothing dumps on a
breaker trip; the event-loop watchdog's wedge dump is the reference's.

Env knobs: TMTPU_TRACE=0 disables, TMTPU_TRACE_RING sizes the ring,
TMTPU_TRACE_DIR points auto-dumps at a directory."""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
from collections import deque

from .clock import SYSTEM, Clock

logger = logging.getLogger("libs.trace")

DEFAULT_RING = 4096

#: process-wide id source — a counter, not uuid/random/time: trace ids
#: never enter protocol output, and a counter keeps seeded paths clean
#: for the nondeterminism analyzer
_ids = itertools.count(1)


class TraceCtx:
    """Propagated handle for one end-to-end trace: the id, the clock the
    trace is timed on, the trace's own t0 (the root span's start), and a
    small `marks` dict for boundary timestamps shared across pipeline
    stages (so stage durations sum EXACTLY to the end-to-end span)."""

    __slots__ = ("trace_id", "t0", "clock", "marks")

    def __init__(self, trace_id: int, t0: float, clock: Clock):
        self.trace_id = trace_id
        self.t0 = t0
        self.clock = clock
        self.marks: dict[str, float] = {}


class Span:
    """One in-progress span (context-manager use only — see the
    span-discipline lint rule). `set(k=v)` attaches attrs mid-flight."""

    __slots__ = ("_rec", "trace_id", "subsystem", "name", "_clock", "_t0", "attrs")

    def __init__(self, rec, trace_id, subsystem, name, clock, attrs):
        self._rec = rec
        self.trace_id = trace_id
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
            self.trace_id,
            self.subsystem,
            self.name,
            self._t0,
            self._clock.monotonic() - self._t0,
            self.attrs or None,
        )


class _NopSpan:
    """Shared do-nothing span for disabled tracing: one module-level
    instance, zero per-call allocation."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NOP_SPAN = _NopSpan()


class FlightRecorder:
    """Bounded per-process span ring (the "flight recorder"). All nodes
    in one process share it — like the VerifyHub they also share — so a
    dump shows the whole funnel, cross-node dedup included."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        ring_size: int = DEFAULT_RING,
        out_dir: str = "",
    ):
        self.enabled = enabled
        self.ring_size = max(1, ring_size)
        self.out_dir = out_dir
        # (trace_id, subsystem, name, start_s, duration_s, attrs|None)
        self._ring: deque[tuple] = deque(maxlen=self.ring_size)
        self.recorded = 0  # total appended; dropped = recorded - len(ring)
        # auto_dump records (reason + path); bounded — /debug/flight?dump=
        # is operator-reachable, and stats() returns this list in every
        # /debug response, so it must not grow without limit
        self.dumps: deque = deque(maxlen=64)
        self._dump_seq = itertools.count(1)

    # -- recording -------------------------------------------------------

    def _append(self, trace_id, subsystem, name, start_s, dur_s, attrs) -> None:
        # deque.append with maxlen evicts the oldest atomically under the
        # GIL — safe from both the event loop and the hub's threads
        self._ring.append((trace_id, subsystem, name, start_s, dur_s, attrs))
        self.recorded += 1

    def start(self, clock: Clock | None = None) -> TraceCtx | None:
        """Open a new trace at the funnel edge; None when disabled (every
        downstream record/finish call then no-ops on the None ctx)."""
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
        """Record one contiguous pipeline stage with explicit boundary
        timestamps (taken from the ctx's clock by the caller)."""
        if ctx is None or not self.enabled:
            return
        self._append(
            ctx.trace_id, subsystem, name, start_s, end_s - start_s, attrs or None
        )

    def finish(self, ctx: TraceCtx | None, subsystem: str, name: str, **attrs) -> None:
        """Close a trace: records the root span [ctx.t0, now]."""
        if ctx is None or not self.enabled:
            return
        now = ctx.clock.monotonic()
        self._append(ctx.trace_id, subsystem, name, ctx.t0, now - ctx.t0, attrs or None)

    def span(
        self,
        subsystem: str,
        name: str,
        *,
        ctx: TraceCtx | None = None,
        clock: Clock | None = None,
        **attrs,
    ) -> Span | _NopSpan:
        """Context-manager span for a code block. With a ctx the span
        joins that trace (and times on its clock); without one it is a
        standalone event on `clock` (default SYSTEM)."""
        if not self.enabled:
            return NOP_SPAN
        if ctx is not None:
            return Span(self, ctx.trace_id, subsystem, name, ctx.clock, attrs)
        return Span(self, 0, subsystem, name, clock or SYSTEM, attrs)

    def emit(
        self,
        subsystem: str,
        name: str,
        *,
        duration_s: float = 0.0,
        clock: Clock | None = None,
        **attrs,
    ) -> None:
        """Point-in-time event (attach attempt, breaker trip): a span of
        the given duration ending now."""
        if not self.enabled:
            return
        now = (clock or SYSTEM).monotonic()
        self._append(0, subsystem, name, now - duration_s, duration_s, attrs or None)

    # -- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._ring)

    def dump(
        self, n: int | None = None, *, subsystem: str | None = None,
        trace_id: int | None = None,
    ) -> list[dict]:
        """Last `n` spans (oldest first) as JSON-ready dicts, optionally
        filtered by subsystem or trace id."""
        spans = list(self._ring)
        out = []
        for tid, sub, name, start, dur, attrs in spans:
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
        if n is not None:
            out = out[-n:]
        return out

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "ring_size": self.ring_size,
            "spans": len(self._ring),
            "recorded": self.recorded,
            "dropped": self.dropped,
            "auto_dumps": list(self.dumps),
        }

    def auto_dump(self, reason: str) -> str | None:
        """Dump the ring because something went wrong (loop wedge, hub
        timeout, breaker trip). Returns the file path when `out_dir` is
        set, else records the event in-memory only. Diagnostics must
        never raise into the caller."""
        if not self.enabled:
            return None
        entry: dict = {"reason": reason, "spans": len(self._ring)}
        path = None
        if self.out_dir:
            try:
                os.makedirs(self.out_dir, exist_ok=True)
                # reasons reach here from operator input too
                # (/debug/flight?dump=<reason>) — keep the filename flat
                safe = re.sub(r"[^A-Za-z0-9._-]+", "_", reason) or "dump"
                path = os.path.join(
                    self.out_dir, f"flight-{safe}-{next(self._dump_seq)}.json"
                )
                with open(path, "w", encoding="utf-8") as f:
                    json.dump({"reason": reason, "spans": self.dump()}, f)
                entry["path"] = path
            except Exception as e:  # noqa: BLE001 — diagnostics must not raise
                logger.warning("flight dump for %r failed: %r", reason, e)
                path = None
        self.dumps.append(entry)
        logger.error(
            "flight recorder dumped (%s): %d spans%s",
            reason,
            len(self._ring),
            f" -> {path}" if path else "",
        )
        return path

    def clear(self) -> None:
        self._ring.clear()
        self.recorded = 0
        self.dumps.clear()


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
        # a malformed diagnostics knob must not kill the process: trace
        # is imported at module level by the whole verify funnel
        logger.warning("ignoring malformed %s=%r (want an int)", name, v)
        return default


#: THE process recorder. Module import reads the env so library users
#: (and tests that set TMTPU_TRACE before import) get the right mode
#: without any node wiring.
RECORDER = FlightRecorder(
    enabled=_env_enabled(True),
    ring_size=_env_int("TMTPU_TRACE_RING", DEFAULT_RING),
    out_dir=os.environ.get("TMTPU_TRACE_DIR", ""),
)


#: set once the first Node applied its `[trace]` section — the recorder
#: is process-wide, so a later node's (possibly default) config must not
#: silently clobber the first one's dump_dir/enabled mid-run
_node_configured = False


def configure_once(
    enabled: bool | None = None,
    ring_size: int | None = None,
    out_dir: str | None = None,
) -> bool:
    """Node-boot hook: apply `[trace]` config the FIRST time a node in
    this process starts; later nodes (multi-node tests, harnesses) are
    no-ops. Returns whether this call configured the recorder. Tests
    that need to reconfigure use `configure` / RECORDER directly."""
    global _node_configured
    if _node_configured:
        return False
    _node_configured = True
    configure(enabled=enabled, ring_size=ring_size, out_dir=out_dir)
    return True


def configure(
    enabled: bool | None = None,
    ring_size: int | None = None,
    out_dir: str | None = None,
) -> FlightRecorder:
    """Apply `[trace]` config to the process recorder. Env wins over
    explicit values (the same contract as the TMTPU_VERIFYHUB_* knobs):
    an operator exporting TMTPU_TRACE=0 silences every in-process node
    regardless of TOML."""
    if enabled is not None:
        RECORDER.enabled = _env_enabled(enabled)
    if ring_size is not None:
        size = _env_int("TMTPU_TRACE_RING", ring_size)
        if size != RECORDER.ring_size:
            RECORDER.ring_size = max(1, size)
            RECORDER._ring = deque(RECORDER._ring, maxlen=RECORDER.ring_size)
    if out_dir is not None:
        RECORDER.out_dir = os.environ.get("TMTPU_TRACE_DIR", "") or out_dir
    return RECORDER


# -- module-level conveniences (the names call sites import) ---------------


def is_enabled() -> bool:
    return RECORDER.enabled


def start(clock: Clock | None = None) -> TraceCtx | None:
    return RECORDER.start(clock)


def record(ctx, subsystem, name, start_s, end_s, **attrs) -> None:
    RECORDER.record(ctx, subsystem, name, start_s, end_s, **attrs)


def finish(ctx, subsystem, name, **attrs) -> None:
    RECORDER.finish(ctx, subsystem, name, **attrs)


def span(subsystem, name, *, ctx=None, clock=None, **attrs):
    return RECORDER.span(subsystem, name, ctx=ctx, clock=clock, **attrs)


def emit(subsystem, name, *, duration_s=0.0, clock=None, **attrs) -> None:
    RECORDER.emit(subsystem, name, duration_s=duration_s, clock=clock, **attrs)


def auto_dump(reason: str) -> str | None:
    return RECORDER.auto_dump(reason)
