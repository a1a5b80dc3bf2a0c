"""HashHub — the process-wide SHA-256 chokepoint (the port's copy of
tendermint_tpu/crypto/hash_hub.py, host path).

Every hot-path hash — part-set roots, tx Merkle roots, header and
app-hash trees, validator-set hashes — goes through `sha256_many` /
`sha256_one` here instead of calling `hashlib` raw.

  * **Lanes.** Callers tag work as block-build (`LANE_BUILD`), verify
    (`LANE_VERIFY`), or light-hop (`LANE_LIGHT`) — explicitly
    (`sha256_many(msgs, lane=...)`) or ambiently via `lane_ctx()` for
    deep call chains. Lanes are accounting, not priority queues: hashing
    is synchronous and microseconds-scale, so there is no scheduler
    thread, only per-lane batch and occupancy counters (`STATS`).
  * **Host only.** One `sha256_many` call per Merkle tree level replaces
    O(n) recursive Python frames. The reference's opt-in device route
    (a jitted SHA-256 behind its shared breaker) has no counterpart yet;
    it waits for the port's SHA-256 kernel, and comes without a breaker.
"""

from __future__ import annotations

import hashlib
import threading
import time

from ..libs import trace

_sha256 = hashlib.sha256

__all__ = [
    "LANE_BUILD",
    "LANE_VERIFY",
    "LANE_LIGHT",
    "sha256_many",
    "sha256_one",
    "lane_ctx",
    "current_lane",
    "stats_snapshot",
    "reset_stats",
]

LANE_BUILD = "build"
LANE_VERIFY = "verify"
LANE_LIGHT = "light"
_LANES = (LANE_BUILD, LANE_VERIFY, LANE_LIGHT)

#: batches at least this wide emit a `hash.batch` span when tracing is on
#: (the reference's device-route threshold; a span per narrow tree level
#: would cost more than the hashing and flood the ring)
MIN_TRACED_BATCH = 256

#: per-lane and global counters; plain dict with unlocked += on the hot
#: path (a rare lost increment in a stats counter is acceptable, a lock
#: in the hash loop is not)
STATS = {
    "batches": 0,
    "messages": 0,
    "singles": 0,
    "max_batch": 0,
    "lane_batches": {lane: 0 for lane in _LANES},
    "lane_messages": {lane: 0 for lane in _LANES},
}


class _LaneLocal(threading.local):
    # class attribute = per-thread default without the AttributeError
    # machinery `getattr(tls, "lane", default)` pays on every miss
    lane = LANE_BUILD


_tls = _LaneLocal()


def current_lane() -> str:
    """The ambient lane set by the innermost `lane_ctx` (LANE_BUILD
    when none is active)."""
    return _tls.lane


class lane_ctx:
    """Ambient lane for a whole call chain. Re-entrant; restores the
    previous lane on exit."""

    def __init__(self, lane: str):
        if lane not in _LANES:
            raise ValueError(f"unknown hash lane {lane!r}")
        self._lane = lane
        self._prev = LANE_BUILD

    def __enter__(self) -> "lane_ctx":
        self._prev = _tls.lane
        _tls.lane = self._lane
        return self

    def __exit__(self, *exc) -> None:
        _tls.lane = self._prev


def sha256_many(msgs: list[bytes], *, lane: str | None = None) -> list[bytes]:
    """Hash a batch of independent messages: one call per Merkle tree
    level. Wide batches (≥ MIN_TRACED_BATCH) emit a `hash.batch` span
    (route "cpu") when tracing is on."""
    n = len(msgs)
    if not n:
        return []
    if lane is None:
        lane = _tls.lane
    st = STATS
    st["batches"] += 1
    st["messages"] += n
    if n > st["max_batch"]:
        st["max_batch"] = n
    st["lane_batches"][lane] += 1
    st["lane_messages"][lane] += n
    s = _sha256
    if n >= MIN_TRACED_BATCH and trace.is_enabled():
        t0 = time.monotonic()
        out = [s(m).digest() for m in msgs]
        trace.emit(
            "hash", "batch", duration_s=time.monotonic() - t0, n=n, lane=lane, route="cpu"
        )
        return out
    return [s(m).digest() for m in msgs]


def sha256_one(data: bytes, *, lane: str | None = None) -> bytes:
    """Single-message funnel for hot paths with nothing to batch."""
    STATS["singles"] += 1
    STATS["lane_messages"][lane if lane is not None else current_lane()] += 1
    return _sha256(data).digest()


def stats_snapshot() -> dict:
    snap = {k: v for k, v in STATS.items() if not isinstance(v, dict)}
    snap["lane_batches"] = dict(STATS["lane_batches"])
    snap["lane_messages"] = dict(STATS["lane_messages"])
    return snap


def reset_stats() -> None:
    """Tests only."""
    for k, v in STATS.items():
        if isinstance(v, dict):
            for lane in v:
                v[lane] = 0
        else:
            STATS[k] = 0
