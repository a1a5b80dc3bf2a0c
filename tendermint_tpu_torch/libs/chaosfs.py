"""The injectable file-I/O layer the WAL writes through (the port's copy of
`FS` and `REAL_FS` from tendermint_tpu/libs/chaosfs.py).

The reference's fault controller (`ChaosFS`, `ChaosDB`, `ChaosFSConfig`:
torn writes, lost fsyncs, ENOSPC, bit-rot) waits for the port of the
scenario harness; until then every storage path runs on `REAL_FS`.
"""

from __future__ import annotations

import os


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
