"""Event-loop liveness watchdog — the port's copy of `LoopWatchdog` from
tendermint_tpu/libs/watchdog.py (the asyncio analog of the reference's
deadlock-detecting mutexes, internal/libs/sync/deadlock.go:1-6).

Go detects a mutex held too long; the equivalent failure mode in a
single-threaded asyncio node is the LOOP wedging: a coroutine doing
blocking I/O / CPU inline, or a genuine deadlock between tasks awaiting
each other. Either way the symptom is identical — the loop stops
scheduling — and the diagnosis needs the same artifact Go prints: where
everything is stuck.

LoopWatchdog runs a daemon THREAD (it must live off the loop to observe
the loop being stuck) that schedules a trivial heartbeat callback via
`call_soon_threadsafe` and waits. If the heartbeat doesn't run within
`threshold_s`, it writes every thread's Python stack and every asyncio
task's stack to `<dir>/wedged-<ts>.txt` and logs loudly. One report per
wedge (re-armed once the loop breathes again) — a wedged loop that
recovers produces exactly one bundle, not a spray. The flight recorder's
spans (the other half of the diagnosis: what ran up to the stall) go into
the same report, and a wedge also dumps the recorder as the reference's
does (`libs/trace.auto_dump`, to ``TMTPU_TRACE_DIR`` or the node's
``[trace]`` dump dir).

The reference's `BackendInitWatchdog` is not ported: it bounds the JAX
backend's attach, and the port has no background probe to bound.
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import os
import sys
import threading
import time
import traceback

logger = logging.getLogger("libs.watchdog")


class LoopWatchdog:
    """Watches one asyncio loop from a side thread.

    start() must be called from the loop's thread (it captures the
    running loop); stop() from anywhere."""

    def __init__(
        self,
        out_dir: str,
        *,
        threshold_s: float = 5.0,
        interval_s: float = 2.0,
    ):
        self.out_dir = out_dir
        self.threshold_s = threshold_s
        self.interval_s = interval_s
        self._loop = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._beat = threading.Event()
        self.reports: list[str] = []  # paths of wedge reports written

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._run, name="loop-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # wake a thread parked in _beat.wait() immediately — without this,
        # stop() called FROM the loop thread would deadlock against its
        # own queued heartbeat for up to threshold_s
        self._beat.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- internals -------------------------------------------------------

    def _run(self) -> None:
        wedged = False
        while not self._stop.is_set():
            self._beat.clear()
            try:
                self._loop.call_soon_threadsafe(self._beat.set)
            except RuntimeError:
                return  # loop closed
            responded = self._beat.wait(self.threshold_s)
            if self._stop.is_set():
                return
            if not responded and not wedged:
                wedged = True
                self._report()
                try:
                    from . import trace

                    trace.auto_dump("loop-wedged")
                except Exception as e:  # noqa: BLE001 — diagnostics only
                    logger.debug("flight dump on wedge failed: %r", e)
            elif responded:
                wedged = False
            self._stop.wait(self.interval_s)

    def _report(self) -> None:
        buf = io.StringIO()
        buf.write(
            f"=== event loop unresponsive for >{self.threshold_s}s "
            f"at {time.strftime('%Y-%m-%dT%H:%M:%S')} ===\n\n"
        )
        frames = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            buf.write(f"--- thread {frames.get(ident, ident)} ---\n")
            buf.write("".join(traceback.format_stack(frame)))
            buf.write("\n")
        # task stacks: enumerable from outside the loop thread —
        # all_tasks(loop) only reads the weak set
        try:
            for task in asyncio.all_tasks(self._loop):
                state = (
                    "cancelled"
                    if task.cancelled()
                    else "done" if task.done() else "pending"
                )
                buf.write(f"--- task {task.get_name()} ({state}) ---\n")
                for f in task.get_stack():
                    buf.write("".join(traceback.format_stack(f)[-1:]))
            buf.write("\n")
        except Exception as e:  # noqa: BLE001 — diagnostics must not raise
            buf.write(f"(task enumeration failed: {e!r})\n")
        try:
            from . import trace

            spans = trace.RECORDER.dump()
            buf.write(f"--- flight recorder ({len(spans)} spans) ---\n")
            for sp in spans:
                buf.write(json.dumps(sp, default=repr) + "\n")
        except Exception as e:  # noqa: BLE001 — diagnostics must not raise
            buf.write(f"(flight recorder dump failed: {e!r})\n")
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"wedged-{int(time.time()*1000)}.txt")
        with open(path, "w") as f:
            f.write(buf.getvalue())
        self.reports.append(path)
        logger.error(
            "event loop wedged >%ss; stacks dumped to %s", self.threshold_s, path
        )
