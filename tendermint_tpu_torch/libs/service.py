"""Async service lifecycle, the analog of the reference's BaseService
(reference libs/service/service.go).

A Service can be started once, stopped once, and exposes `wait_stopped()`.
Subclasses override `on_start` / `on_stop`. Unlike the Go original there is
no goroutine bookkeeping — asyncio tasks registered via `spawn` are cancelled
on stop.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine


class Service:
    def __init__(self, name: str | None = None, logger: logging.Logger | None = None):
        self.name = name or type(self).__name__
        self.logger = logger or logging.getLogger(self.name)
        self._started = False
        self._stopped = asyncio.Event()
        self._stopping = False
        self._tasks: list[asyncio.Task] = []

    @property
    def is_running(self) -> bool:
        return self._started and not self._stopping

    async def start(self) -> None:
        if self._started:
            raise RuntimeError(f"service {self.name} already started")
        self._started = True
        self.logger.debug("starting %s", self.name)
        await self.on_start()

    #: per-task reap grace before a second cancel is issued (stop() must
    #: terminate even when a task resists cancellation)
    STOP_GRACE = 2.0

    async def stop(self) -> None:
        if not self._started or self._stopping:
            return
        self._stopping = True
        self.logger.debug("stopping %s", self.name)
        await self.on_stop()
        # Reap with three hardenings over a naive `for t: await t`:
        #  * snapshot + re-scan: done-callbacks mutate self._tasks during
        #    the loop (a live-list `for` skips entries), and teardown
        #    paths legitimately spawn late tasks (e.g. _disconnect_peer)
        #    that must be reaped too;
        #  * re-cancel on timeout: pre-3.11 asyncio.wait_for can ABSORB a
        #    cancellation that races the inner future's completion,
        #    leaving a "cancelled" task running its loop forever — the
        #    second cancel lands at its next await;
        #  * bounded waits: a task that still refuses to die is logged
        #    and abandoned rather than wedging the whole shutdown.
        seen: set[asyncio.Task] = set()
        queue = list(self._tasks)
        # broadcast the first cancel to EVERY task up front: the reap below
        # is sequential, and a stuck task must not delay its siblings'
        # cancellation (they'd keep routing/dialing mid-shutdown)
        for t in queue:
            t.cancel()
        while queue:
            t = queue.pop()
            if t in seen:
                continue
            seen.add(t)
            # asyncio.wait (unlike wait_for) neither cancels nor awaits the
            # task on timeout, so each grace window is a TRUE bound even
            # against a task that absorbs cancellation
            t.cancel()
            _done, not_done = await asyncio.wait({t}, timeout=self.STOP_GRACE)
            if not_done:
                t.cancel()
                _done, not_done = await asyncio.wait({t}, timeout=self.STOP_GRACE)
                if not_done:
                    self.logger.warning(
                        "%s: task %s did not stop; abandoning",
                        self.name,
                        t.get_name(),
                    )
            if t.done() and not t.cancelled():
                t.exception()  # consume, silencing 'never retrieved'
            # teardown paths legitimately spawn late tasks (e.g.
            # _disconnect_peer); queue them un-cancelled so their cleanup
            # runs — the bounded reap cancels them when their turn comes
            queue.extend(x for x in self._tasks if x not in seen and x not in queue)
        self._tasks.clear()
        self._stopped.set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    def spawn(self, coro: Coroutine, name: str | None = None) -> asyncio.Task:
        """Run a coroutine for the lifetime of the service."""
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.append(task)
        task.add_done_callback(self._on_task_done)
        return task

    def _on_task_done(self, task: asyncio.Task) -> None:
        try:
            self._tasks.remove(task)
        except ValueError:
            pass
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None and not self._stopping:
            self.logger.error("task %s crashed: %r", task.get_name(), exc)

    async def on_start(self) -> None:  # override
        pass

    async def on_stop(self) -> None:  # override
        pass
