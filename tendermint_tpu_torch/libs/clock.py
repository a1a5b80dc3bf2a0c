"""Injectable time sources — the port's copy of
tendermint_tpu/libs/clock.py (the deterministic-clock analog of the
reference's tmtime package, plus the chaos side: per-validator skew).

Consensus stamps wall-clock time into protocol output — vote timestamps
(`ConsensusState._vote_time_ns`) and, through the weighted-median rule,
block header times — so chaos matrices over live consensus were not
bit-reproducible: two runs with the same fault seed produced different
hashes purely because `time.time_ns()` moved. Threading a `Clock`
through `consensus/state.py`, `ticker.py`, and `reactor.py` fixes both
halves:

  * determinism — a `ManualClock` frozen at (or behind) genesis makes
    every vote timestamp collapse to `block_time + 1ms` via the
    vote-time minimum rule (state.go:2237 voteTime), so timestamps are
    a pure function of (height, genesis_time): identical across runs
    regardless of asyncio scheduling;
  * clock skew as a fault class — a `SkewedClock` per validator (offset
    drawn deterministically from the chaos seed, libs/chaos.py
    `ChaosNetwork.clock_for`) models committee deployments where NTP
    drift puts validators hundreds of ms apart, and `rate` models a
    fast/slow oscillator (timeouts fire early/late through the ticker).

The default `SYSTEM` clock is `time.time_ns()` — production behavior is
unchanged unless a clock is injected.
"""

from __future__ import annotations

import time


class Clock:
    """Time source interface. `now_ns` is the wall-clock reading stamped
    into votes/blocks; `rate` scales *durations* (a 1.05 clock runs 5%
    fast: its owner's timeouts fire early by that factor)."""

    rate: float = 1.0

    def now_ns(self) -> int:
        raise NotImplementedError

    def timeout_s(self, duration_ns: int) -> float:
        """Real seconds this clock's owner waits for a nominal duration."""
        return duration_ns / 1e9 / self.rate

    def monotonic_ns(self) -> int:
        """Duration/deadline domain: RTO samples, ban cooldowns, grace
        windows. Never stamped into protocol output, and it always
        advances — a ManualClock freezes only the wall-clock domain, so
        deadline watchdogs (e.g. `wait_for_height`) still fire under a
        frozen clock. Scaled by `rate`: a fast oscillator's owner sees
        durations elapse early, matching its scaled timeouts."""
        return int(time.monotonic_ns() * self.rate)

    def monotonic(self) -> float:
        """`monotonic_ns` in float seconds (the time.monotonic shape)."""
        return self.monotonic_ns() / 1e9


class SystemClock(Clock):
    def now_ns(self) -> int:
        return time.time_ns()


class ManualClock(Clock):
    """Frozen/settable clock for deterministic tests. Never advances on
    its own; `advance()`/`set_ns()` move it explicitly."""

    def __init__(self, start_ns: int = 0, rate: float = 1.0):
        self._now_ns = start_ns
        self.rate = rate

    def now_ns(self) -> int:
        return self._now_ns

    def advance(self, delta_ns: int) -> None:
        self._now_ns += delta_ns

    def set_ns(self, now_ns: int) -> None:
        self._now_ns = now_ns


class SkewedClock(Clock):
    """A clock offset (and optionally drifting) from a base clock — one
    validator's wrong wall clock in a chaos run."""

    def __init__(self, base: Clock | None = None, offset_ns: int = 0, rate: float = 1.0):
        self.base = base or SYSTEM
        self.offset_ns = offset_ns
        self.rate = rate

    def now_ns(self) -> int:
        return self.base.now_ns() + self.offset_ns


SYSTEM = SystemClock()
