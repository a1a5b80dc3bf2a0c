"""Chaos-fs: seeded, deterministic storage-fault injection (the port's
copy of tendermint_tpu/libs/chaosfs.py).

`libs/chaos.py` covers the network half of the fault model; this module
covers the disk half — the write path under `consensus/wal.py`,
`store/blockstore.py`, `store/db.py`, and `state/store.py`. It is both
the **injectable I/O layer** those subsystems are required to use (the
tmtlint `fs-discipline` rule forbids raw `open(.., "wb")`/`os.fsync`
there, and `transitive-fs` forbids reaching one through a helper in
another file) and the fault controller that perturbs it.

Fault classes (all per-operation, all drawn from ONE seeded RNG so a
fault schedule is reproducible):

  * **torn writes** — at `simulate_crash()`, un-fsynced bytes survive
    only partially: the tail is cut at a seeded (or configured,
    `torn_offset`) byte offset, typically mid-record. This is the
    sector-granularity reality `fsync` exists to paper over.
  * **lost-but-acked fsyncs** — `fsync` returns success but the durable
    watermark does not advance; the "synced" bytes are torn away by the
    next crash. Models firmware write-cache lies.
  * **disk-full (ENOSPC) mid-record** — a write persists only a prefix
    and raises `OSError(ENOSPC)`; either probabilistic (`enospc_rate`)
    or armed at an exact cumulative byte count (`enospc_at_byte`).
  * **bit-rot on read** — a read returns one flipped byte
    (`bitrot_rate`), exercising CRC detection and WAL repair.

The crash model: bytes below the per-file durable watermark (advanced by
honest fsyncs) ALWAYS survive `simulate_crash()`; bytes above it are
dropped, except a torn partial tail. `WAL.repair()` must therefore bring
any post-crash file back to a replayable state.

`ChaosDB` applies the ENOSPC/bit-rot classes to any `store.db.DB`
(SQLite batches are atomic, so torn DB writes cannot happen by
construction — the WAL is where torn writes live).

Env mirror (`config.ChaosFSConfig`): TMTPU_CHAOS_FS_SEED, _TORN,
_TORN_OFFSET, _LOST_FSYNC, _ENOSPC, _ENOSPC_AT, _BITROT.
"""

from __future__ import annotations

import errno
import os
import random
from dataclasses import dataclass
from typing import Iterator

from ..store.db import DB


@dataclass(frozen=True)
class ChaosFSConfig:
    seed: int = 0
    torn_write_rate: float = 0.0  # P(un-fsynced tail is torn, not dropped, at crash)
    torn_offset: int = -1  # fixed tear offset into the volatile tail; -1 = seeded
    lost_fsync_rate: float = 0.0  # P(fsync acked but not durable)
    enospc_rate: float = 0.0  # P(write fails ENOSPC mid-record)
    enospc_at_byte: int = -1  # arm ENOSPC at an exact cumulative byte; -1 = off
    bitrot_rate: float = 0.0  # P(read returns one flipped byte)

    @classmethod
    def from_env(cls) -> "ChaosFSConfig":
        def f(name: str, default: float = 0.0) -> float:
            raw = os.environ.get(name, "")
            return float(raw) if raw else default

        return cls(
            seed=int(os.environ.get("TMTPU_CHAOS_FS_SEED", "0") or 0),
            torn_write_rate=f("TMTPU_CHAOS_FS_TORN"),
            torn_offset=int(os.environ.get("TMTPU_CHAOS_FS_TORN_OFFSET", "-1") or -1),
            lost_fsync_rate=f("TMTPU_CHAOS_FS_LOST_FSYNC"),
            enospc_rate=f("TMTPU_CHAOS_FS_ENOSPC"),
            enospc_at_byte=int(os.environ.get("TMTPU_CHAOS_FS_ENOSPC_AT", "-1") or -1),
            bitrot_rate=f("TMTPU_CHAOS_FS_BITROT"),
        )

    def enabled(self) -> bool:
        return any(
            (
                self.torn_write_rate,
                self.lost_fsync_rate,
                self.enospc_rate,
                self.enospc_at_byte >= 0,
                self.bitrot_rate,
            )
        )


def _flip_one_byte(rng: random.Random, data: bytes) -> bytes:
    """One seeded bit-rot hit: a single byte XORed with a nonzero mask."""
    i = rng.randrange(len(data))
    flip = 1 + rng.getrandbits(8) % 255
    return data[:i] + bytes([data[i] ^ flip]) + data[i + 1 :]


class FS:
    """The injectable file-I/O layer. The real implementation is this
    base class; `ChaosFS` perturbs it. Storage subsystems take an `fs`
    and never touch `open`/`os.fsync` directly (lint-enforced)."""

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def rename(self, src: str, dst: str) -> None:
        os.rename(src, dst)

    def remove(self, path: str) -> None:
        os.remove(path)

    def truncate(self, path: str, size: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(size)

    def listdir(self, path: str) -> list[str]:
        return os.listdir(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def getsize(self, path: str) -> int:
        return os.path.getsize(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)


REAL_FS = FS()


class _ChaosFile:
    """File wrapper that routes durability and fault rolls through the
    owning ChaosFS controller."""

    def __init__(self, fs: "ChaosFS", inner, path: str, writable: bool):
        self._fs = fs
        self._inner = inner
        self.path = path
        self._writable = writable

    def write(self, data: bytes) -> int:
        return self._fs._write(self, data)

    def read(self, n: int = -1) -> bytes:
        return self._fs._read(self, self._inner.read(n))

    def flush(self) -> None:
        self._inner.flush()

    def fileno(self) -> int:
        return self._inner.fileno()

    def tell(self) -> int:
        return self._inner.tell()

    def seek(self, pos: int, whence: int = 0) -> int:
        return self._inner.seek(pos, whence)

    def truncate(self, size: int | None = None) -> int:
        return self._inner.truncate(size)

    def close(self) -> None:
        self._inner.close()

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ChaosFS(FS):
    """Seeded fault-injecting FS + the shared storage-chaos controller
    (also wraps DBs via `wrap_db`). One RNG, one fault-counter map."""

    def __init__(self, config: ChaosFSConfig | None = None):
        self.config = config or ChaosFSConfig()
        self.rng = random.Random(self.config.seed)
        # path -> durable byte watermark (bytes guaranteed to survive a
        # simulated crash). Only files opened for writing are tracked.
        self.durable: dict[str, int] = {}
        self._written = 0  # cumulative bytes, drives enospc_at_byte
        self._halted = False  # "the process just died": fsyncs stop counting
        self._enospc_fired = False  # enospc_at_byte is one-shot (disk freed)
        self.faults: dict[str, int] = {
            "torn_write": 0, "lost_fsync": 0, "enospc": 0, "bitrot": 0,
            "crash_lost_bytes": 0, "db_enospc": 0, "db_bitrot": 0,
        }

    # -- FS interface ----------------------------------------------------

    def open(self, path: str, mode: str = "rb"):
        inner = open(path, mode)
        writable = any(c in mode for c in "wa+x")
        if writable and path not in self.durable:
            # pre-existing bytes survived a previous session: durable
            self.durable[path] = self.getsize(path) if self.exists(path) else 0
        if "w" in mode or "x" in mode:
            self.durable[path] = 0
        return _ChaosFile(self, inner, path, writable)

    def fsync(self, f) -> None:
        if not isinstance(f, _ChaosFile):
            REAL_FS.fsync(f)
            return
        f.flush()
        os.fsync(f.fileno())
        if self._halted:
            return  # post-mortem teardown: nothing becomes durable anymore
        cfg = self.config
        if cfg.lost_fsync_rate > 0 and self.rng.random() < cfg.lost_fsync_rate:
            self.faults["lost_fsync"] += 1
            return  # acked, but the watermark does not move
        self.durable[f.path] = os.fstat(f.fileno()).st_size

    def rename(self, src: str, dst: str) -> None:
        os.rename(src, dst)
        if src in self.durable:
            self.durable[dst] = self.durable.pop(src)

    def remove(self, path: str) -> None:
        os.remove(path)
        self.durable.pop(path, None)

    def truncate(self, path: str, size: int) -> None:
        REAL_FS.truncate(path, size)
        if path in self.durable:
            self.durable[path] = min(self.durable[path], size)

    # -- fault rolls (called by _ChaosFile) ------------------------------

    def _write(self, f: _ChaosFile, data: bytes) -> int:
        cfg = self.config
        full = len(data)
        cut = -1
        if (
            not self._enospc_fired
            and 0 <= cfg.enospc_at_byte <= self._written + full
        ):
            # one-shot: the disk is "full" once; the post-restart process
            # finds space again (the operator freed it)
            self._enospc_fired = True
            cut = max(0, cfg.enospc_at_byte - self._written)
        elif cfg.enospc_rate > 0 and self.rng.random() < cfg.enospc_rate:
            cut = self.rng.randrange(full) if full else 0
        if cut >= 0:
            self.faults["enospc"] += 1
            f._inner.write(data[:cut])
            self._written += cut
            raise OSError(errno.ENOSPC, "chaosfs: no space left on device", f.path)
        f._inner.write(data)
        self._written += full
        return full

    def _read(self, f: _ChaosFile, data: bytes) -> bytes:
        cfg = self.config
        if data and cfg.bitrot_rate > 0 and self.rng.random() < cfg.bitrot_rate:
            self.faults["bitrot"] += 1
            return _flip_one_byte(self.rng, data)
        return data

    # -- the crash -------------------------------------------------------

    def halt(self) -> None:
        """Freeze the durability view: the process "dies" HERE. In-process
        harnesses still run clean teardown (Service.stop flushes + fsyncs
        the WAL), which a real crash never gets — calling `halt()` first
        makes those post-mortem fsyncs no-ops on the watermark, so
        `simulate_crash()` reflects the crash instant."""
        self._halted = True

    def simulate_crash(self) -> dict[str, int]:
        """Apply the crash model: every tracked file loses its un-fsynced
        tail — entirely, or (torn-write roll) down to a partial, usually
        mid-record, fragment. Returns {path: surviving_size}. Call with
        writers closed (the in-process analog of the process dying)."""
        cfg = self.config
        out: dict[str, int] = {}
        for path in sorted(self.durable):  # sorted: deterministic RNG order
            if not self.exists(path):
                continue
            size = self.getsize(path)
            keep = min(self.durable[path], size)
            volatile = size - keep
            if volatile > 0:
                if cfg.torn_write_rate > 0 and self.rng.random() < cfg.torn_write_rate:
                    self.faults["torn_write"] += 1
                    if cfg.torn_offset >= 0:
                        keep += min(cfg.torn_offset, volatile)
                    else:
                        keep += self.rng.randrange(1, volatile + 1)
                self.faults["crash_lost_bytes"] += size - keep
                REAL_FS.truncate(path, keep)
            self.durable[path] = keep
            out[path] = keep
        self._halted = False  # the restarted process fsyncs for real again
        return out

    # -- DB side ---------------------------------------------------------

    def wrap_db(self, db: DB) -> "ChaosDB":
        return ChaosDB(self, db)


class ChaosDB(DB):
    """ENOSPC + bit-rot injection over any DB. Batches stay atomic (the
    real engines guarantee that); a failed batch applies nothing."""

    def __init__(self, fs: ChaosFS, inner: DB):
        self.fs = fs
        self.inner = inner

    def _roll_enospc(self) -> None:
        cfg = self.fs.config
        if cfg.enospc_rate > 0 and self.fs.rng.random() < cfg.enospc_rate:
            self.fs.faults["db_enospc"] += 1
            raise OSError(errno.ENOSPC, "chaosfs: db write hit disk-full")

    def _rot(self, value: bytes | None) -> bytes | None:
        cfg = self.fs.config
        if (
            value
            and cfg.bitrot_rate > 0
            and self.fs.rng.random() < cfg.bitrot_rate
        ):
            self.fs.faults["db_bitrot"] += 1
            return _flip_one_byte(self.fs.rng, value)
        return value

    def get(self, key: bytes) -> bytes | None:
        return self._rot(self.inner.get(key))

    def set(self, key: bytes, value: bytes) -> None:
        self._roll_enospc()
        self.inner.set(key, value)

    def delete(self, key: bytes) -> None:
        self.inner.delete(key)

    def iterate(
        self, start: bytes = b"", end: bytes | None = None, reverse: bool = False
    ) -> Iterator[tuple[bytes, bytes]]:
        for k, v in self.inner.iterate(start, end, reverse):
            yield k, self._rot(v)

    def write_batch(self, sets, deletes=()):
        self._roll_enospc()
        self.inner.write_batch(sets, deletes)

    def close(self) -> None:
        self.inner.close()
