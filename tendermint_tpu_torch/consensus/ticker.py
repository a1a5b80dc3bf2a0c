"""Timeout scheduling (reference internal/consensus/ticker.go:17; the port's
copy of tendermint_tpu/consensus/ticker.py, on libs/clock.py).

One pending timeout at a time: scheduling a new timeout for a later
(height, round, step) replaces the pending one; stale schedules (for an
earlier HRS than the pending) are ignored. Fired timeouts are delivered
as `TimeoutInfo` on `tock` — the consensus state machine consumes them
exactly like the reference's tockChan."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from ..libs.clock import SYSTEM, Clock
from .types import RoundStep


@dataclass(frozen=True)
class TimeoutInfo:
    duration_ns: int
    height: int
    round: int
    step: RoundStep

    def hrs(self):
        return (self.height, self.round, self.step)


class TimeoutTicker:
    def __init__(self, tock: "asyncio.Queue | None" = None, clock: Clock | None = None):
        # fired timeouts are delivered here; the consensus SM passes its
        # merged input queue. The clock scales timeout durations: a
        # drifting validator (libs/clock.SkewedClock with rate != 1)
        # fires its consensus timeouts early/late, which is exactly the
        # fault the chaos clock-skew class wants to exercise.
        self.tock: asyncio.Queue = tock if tock is not None else asyncio.Queue()
        self.clock = clock or SYSTEM
        self._pending: TimeoutInfo | None = None
        self._timer: asyncio.TimerHandle | None = None

    def schedule(self, ti: TimeoutInfo) -> None:
        """Replace the pending timeout if ti is for a later-or-equal HRS
        (reference ticker.go timeoutRoutine: newer HRS wins; older is
        ignored)."""
        if self._pending is not None and ti.hrs() < self._pending.hrs():
            return
        self._cancel()
        self._pending = ti
        loop = asyncio.get_running_loop()
        self._timer = loop.call_later(self.clock.timeout_s(ti.duration_ns), self._fire, ti)

    def _fire(self, ti: TimeoutInfo) -> None:
        if self._pending is ti:
            self._pending = None
            self._timer = None
        self.tock.put_nowait(ti)

    def _cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._pending = None

    def stop(self) -> None:
        self._cancel()
