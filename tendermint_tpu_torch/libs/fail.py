"""Crash-point injection (reference internal/libs/fail/fail.go:27).

Numbered `fail_point(n)` call sites sit at every commit sub-step; setting
FAIL_TEST_INDEX=n makes the n-th point terminate the process, letting the
crash-recovery matrix exercise a restart at EVERY intermediate state
(reference call sites state.go:1647-1712, execution.go:170-217).

Tests run in-process, so `set_crash_callback` replaces the default
os._exit with an exception the harness treats as the crash."""

from __future__ import annotations

import os
from typing import Callable

_callback: Callable[[int], None] | None = None
_index: int | None = None
_counter = 0


class InjectedCrash(BaseException):
    """Raised instead of exiting when a test callback is installed.
    BaseException so ordinary `except Exception` recovery paths don't
    swallow the simulated crash."""

    def __init__(self, point: int):
        super().__init__(f"injected crash at fail point {point}")
        self.point = point


def _get_index() -> int | None:
    global _index
    if _index is None:
        raw = os.environ.get("FAIL_TEST_INDEX", "")
        _index = int(raw) if raw else -1
    return _index


def set_crash_callback(cb: Callable[[int], None] | None, index: int | None = None) -> None:
    """Install a test crash handler and (optionally) override the index."""
    global _callback, _index, _counter
    _callback = cb
    _counter = 0
    if index is not None:
        _index = index


def reset() -> None:
    global _callback, _index, _counter
    _callback = None
    _index = None
    _counter = 0


def fail_point(point: int) -> None:
    """Crash if FAIL_TEST_INDEX (or the test override) equals this
    call-site number (reference fail.Fail)."""
    idx = _get_index()
    if idx is None or idx < 0 or point != idx:
        return
    if _callback is not None:
        _callback(point)
        return
    os._exit(99)
