"""HashHub — the process-wide SHA-256 chokepoint (the port's copy of
tendermint_tpu/crypto/hash_hub.py).

Every hot-path hash — part-set roots, tx Merkle roots, header and
app-hash trees, validator-set hashes — goes through `sha256_many` /
`sha256_one` here instead of calling `hashlib` raw.

  * **Lanes.** Callers tag work as block-build (`LANE_BUILD`), verify
    (`LANE_VERIFY`), or light-hop (`LANE_LIGHT`) — explicitly
    (`sha256_many(msgs, lane=...)`) or ambiently via `lane_ctx()` for
    deep call chains. Lanes are accounting, not priority queues: hashing
    is synchronous and microseconds-scale, so there is no scheduler
    thread, only per-lane batch and occupancy counters (`STATS`).
  * **Routes.** One `sha256_many` call per Merkle tree level replaces
    O(n) recursive Python frames. A batch goes to the host (a hashlib
    loop) unless the device route is switched on with
    `use_device(device)`: then a batch of at least `MIN_DEVICE_BATCH`
    messages, each at most 503 bytes, hashes through the SHA-256 kernel
    B8 (crypto/cuda/sha256.py) on that device, in one launch that pads
    the messages on the card — the reference's opt-in
    `TMTPU_HASH_TPU=1`, as a runtime switch like `merkle.use_hashhub`.
    Narrower batches and longer messages hash on the host, as in the
    reference; `STATS` counts both routes. There is no breaker and no
    host re-hash: a device error raises out of `sha256_many`.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

from ..device import resolve
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
    "use_device",
]

LANE_BUILD = "build"
LANE_VERIFY = "verify"
LANE_LIGHT = "light"
_LANES = (LANE_BUILD, LANE_VERIFY, LANE_LIGHT)

#: the device route engages only for batches at least this wide: the
#: reference's default, and TMTPU_MIN_HASH_BATCH sets it as it does
#: there (read once, at import). Measured on
#: an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 16, widths 16
#: to 16,384 in powers of two), the route beat the hashlib loop from 512
#: messages (from 256 for 251-byte leaves in one run of five), for
#: 251-byte leaves and for 65-byte inner nodes alike, and lost below:
#: a call costs ~0.1-0.2 ms of fixed host work (two copies,
#: a launch, the join and the split) before its ~0.2-0.3 us a message. Wide
#: batches also emit a `hash.batch` span when tracing is on (a span per
#: narrow tree level would cost more than the hashing and flood the ring)
MIN_DEVICE_BATCH = int(os.environ.get("TMTPU_MIN_HASH_BATCH", "256"))

#: per-lane and global counters; plain dict with unlocked += on the hot
#: path (a rare lost increment in a stats counter is acceptable, a lock
#: in the hash loop is not)
STATS = {
    "batches": 0,
    "messages": 0,
    "singles": 0,
    "device_batches": 0,
    "device_messages": 0,
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


#: the device the route hashes on; None = every batch on the host (the
#: reference's default, TMTPU_HASH_TPU unset)
_device = None


def use_device(device) -> None:
    """Switch the device route on (`device`: "cuda", "cpu", a
    torch.device) or off (None). "cpu" runs the kernel's plain version,
    for tests. Resolved here: "cuda" without a card raises."""
    global _device
    _device = None if device is None else resolve(device)


def _device_many(msgs: list[bytes], dev) -> list[bytes] | None:
    """The batch through B8 on `dev`, or None when a message is longer
    than the kernel takes (long messages, such as 64 KiB block parts,
    are host work). A device error raises."""
    from .cuda import sha256 as dev_sha

    lengths = dev_sha.message_lengths(msgs)
    if int(lengths.max()) > dev_sha.max_device_bytes():
        return None
    out = dev_sha.sha256_device(msgs, device=dev, lengths=lengths)
    STATS["device_batches"] += 1
    STATS["device_messages"] += len(msgs)
    return out


def sha256_many(msgs: list[bytes], *, lane: str | None = None) -> list[bytes]:
    """Hash a batch of independent messages: one call per Merkle tree
    level. With the device route on, a batch of at least
    MIN_DEVICE_BATCH short messages hashes on the device; every other
    batch is one hashlib loop. Bytes are identical on every route. Wide
    batches (≥ MIN_DEVICE_BATCH) emit a `hash.batch` span with their
    route when tracing is on: "cuda" (the kernel), "plain" (its plain
    version, the route switched on with "cpu") or "cpu" (hashlib)."""
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
    if n >= MIN_DEVICE_BATCH:
        tracing = trace.is_enabled()
        t0 = time.monotonic() if tracing else 0.0
        dev = _device
        out = _device_many(msgs, dev) if dev is not None else None
        route = "cpu" if out is None else ("cuda" if dev.type == "cuda" else "plain")
        if out is None:
            out = [s(m).digest() for m in msgs]
        if tracing:
            trace.emit(
                "hash", "batch", duration_s=time.monotonic() - t0, n=n, lane=lane, route=route
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
