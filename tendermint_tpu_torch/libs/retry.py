"""Unified retry/backoff/circuit-breaker primitives (the port's copy of
tendermint_tpu/libs/retry.py; in the port they guard provider fetches
only — no device call goes through a breaker or a retry).

Every subsystem that talks to an unreliable dependency — a peer over the
network (blocksync, statesync, light client) or an accelerator backend
(crypto/batch) — shares these three pieces instead of growing its own
fixed-timeout loop:

  * `BackoffPolicy` — exponential backoff with FULL jitter (AWS
    architecture-blog formulation: sleep = uniform(0, min(cap, base·2^n));
    full jitter decorrelates retry storms after a common-cause failure,
    which truncated jitter does not).
  * `retry()` — drives an async callable under a policy + deadline.
  * `CircuitBreaker` — classic closed → open → half-open machine: after
    `failure_threshold` consecutive failures the circuit opens and calls
    fail fast; after `reset_timeout` one probe is admitted (half-open);
    its success closes the circuit, its failure re-opens with the timeout
    doubled up to `max_reset_timeout`.

The RNG is injectable so tests pin jitter; time is injectable so breaker
tests don't sleep."""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Iterator


@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff, full jitter, optional attempt/elapsed limits."""

    base: float = 0.1  # first-retry ceiling, seconds
    cap: float = 10.0  # per-sleep ceiling
    multiplier: float = 2.0
    max_attempts: int = 0  # 0 = unbounded (deadline still applies)
    deadline: float = 0.0  # total elapsed budget, seconds; 0 = none

    def sleep_for(self, attempt: int, rng: random.Random | None = None) -> float:
        """Jittered sleep before retry number `attempt` (0-based)."""
        ceiling = min(self.cap, self.base * self.multiplier**attempt)
        return (rng or random).uniform(0.0, ceiling)

    def sleeps(self, rng: random.Random | None = None) -> Iterator[float]:
        """The (possibly unbounded) sleep sequence, for callers that drive
        their own loop."""
        attempt = 0
        while self.max_attempts <= 0 or attempt < self.max_attempts:
            yield self.sleep_for(attempt, rng)
            attempt += 1


class RetriesExhaustedError(Exception):
    """All attempts failed; `last` carries the final underlying error."""

    def __init__(self, attempts: int, last: BaseException | None):
        super().__init__(f"retries exhausted after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last


async def retry(
    fn: Callable[[], Awaitable],
    policy: BackoffPolicy,
    *,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    give_up_on: tuple[type[BaseException], ...] = (),
    rng: random.Random | None = None,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Callable[[int, BaseException], None] | None = None,
):
    """Run `fn` until it returns, raising RetriesExhaustedError when the
    policy's attempt budget or deadline runs out. Exceptions outside
    `retry_on` — or inside `give_up_on`, which wins even over a matching
    retry_on base class (e.g. a definitive not-found subclassing a
    transient error type) — propagate immediately."""
    start = clock()
    attempt = 0
    last: BaseException | None = None
    while True:
        try:
            return await fn()
        except give_up_on:
            raise
        except retry_on as e:
            last = e
        attempt += 1
        if policy.max_attempts > 0 and attempt >= policy.max_attempts:
            raise RetriesExhaustedError(attempt, last)
        delay = policy.sleep_for(attempt - 1, rng)
        if policy.deadline > 0 and clock() - start + delay > policy.deadline:
            raise RetriesExhaustedError(attempt, last)
        if on_retry is not None:
            on_retry(attempt, last)
        await asyncio.sleep(delay)


class CircuitOpenError(Exception):
    """Call refused: the circuit is open (failing fast)."""


@dataclass
class CircuitBreaker:
    """Consecutive-failure circuit breaker with exponential re-open
    timeout. Synchronous and event-loop-free: callers guard work with
    `allow()` and report outcomes via `record_success()/record_failure()`,
    or wrap both in the `guard()` context manager."""

    failure_threshold: int = 3
    reset_timeout: float = 5.0
    max_reset_timeout: float = 300.0
    clock: Callable[[], float] = time.monotonic
    name: str = ""

    _failures: int = field(default=0, init=False)
    _state: str = field(default="closed", init=False)  # closed|open|half-open
    _opened_at: float = field(default=0.0, init=False)
    _current_timeout: float = field(default=0.0, init=False)
    #: lifetime counters for metrics/introspection
    opens: int = field(default=0, init=False)
    half_opens: int = field(default=0, init=False)

    @property
    def state(self) -> str:
        # surface the half-open transition lazily: "open" becomes
        # "half-open" the moment the reset timeout elapses
        if self._state == "open" and (
            self.clock() - self._opened_at >= self._current_timeout
        ):
            return "half-open"
        return self._state

    def allow(self) -> bool:
        """May the caller attempt the protected operation right now?
        In half-open, exactly one probe is admitted per reset window."""
        st = self.state
        if st == "closed":
            return True
        if st == "half-open" and self._state == "open":
            # claim the single probe slot
            self._state = "half-open"
            self.half_opens += 1
            return True
        return False

    def record_success(self) -> None:
        self._failures = 0
        self._state = "closed"
        self._current_timeout = 0.0

    def record_failure(self) -> None:
        if self._state == "half-open":
            # probe failed: re-open with a doubled timeout
            self._trip(self._current_timeout * 2)
            return
        if self._state == "open":
            # a straggler call that started before the trip; the clock
            # is already running, don't extend it
            return
        self._failures += 1
        if self._failures >= self.failure_threshold:
            self._trip(self.reset_timeout)

    def _trip(self, timeout: float) -> None:
        self._state = "open"
        self._opened_at = self.clock()
        self._current_timeout = min(
            max(timeout, self.reset_timeout), self.max_reset_timeout
        )
        self.opens += 1

    def guard(self) -> "_BreakerGuard":
        """`with breaker.guard(): ...` — raises CircuitOpenError when the
        circuit refuses the call, records success/failure from whether the
        body raised."""
        return _BreakerGuard(self)


class _BreakerGuard:
    def __init__(self, breaker: CircuitBreaker):
        self.breaker = breaker

    def __enter__(self) -> CircuitBreaker:
        if not self.breaker.allow():
            raise CircuitOpenError(
                f"circuit {self.breaker.name or 'breaker'} is open"
            )
        return self.breaker

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        return False
