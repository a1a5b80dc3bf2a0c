"""Write-ahead log (reference internal/consensus/wal.go, autofile group; the
port's copy of tendermint_tpu/consensus/wal.py, whose files it writes
byte for byte).

Every consensus input (peer msg, internal msg, timeout) is WAL-written
before it is processed, so a crashed node can deterministically replay to
its pre-crash state. Records are CRC32+length framed; `EndHeight` marker
records delimit completed heights (reference wal.go:288 WALEncoder,
EndHeightMessage).

Files: `wal` is the head; at `head_size_limit` it rotates to `wal.000`,
`wal.001`, … (the autofile.Group analog); replay reads rotated files in
order, then the head.

Crash consistency: all file I/O goes through an injectable `libs.chaosfs.FS`
(lint-enforced by the tmtlint fs-discipline + transitive-fs rules,
`scripts/tmtlint`) so storage faults — torn
writes, lost fsyncs, ENOSPC mid-record, bit-rot — are testable. On open,
`repair()` scans every file and truncates to the last whole record,
moving any damaged tail aside into `<file>.corrupt.<n>` instead of
raising: a node killed mid-write restarts without manual intervention,
and the exact truncation point is logged (consensus/replay.py
`report_wal_repair`). A mid-record ENOSPC rolls the partial frame back so
the log never grows an undetected garbage gap."""

from __future__ import annotations

import logging
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator

from ..libs import protoenc as pe
from ..libs.chaosfs import FS, REAL_FS
from ..libs.metrics import record_storage

_FRAME = struct.Struct("<II")  # crc32, length
MAX_RECORD_SIZE = 1 << 20

KIND_MESSAGE = 1
KIND_END_HEIGHT = 2


@dataclass(frozen=True)
class WALRecord:
    kind: int
    time_ns: int
    data: bytes  # opaque consensus message (KIND_MESSAGE)
    height: int = 0  # KIND_END_HEIGHT

    def encode(self) -> bytes:
        out = pe.varint_field(1, self.kind)
        out += pe.varint_field(2, self.time_ns)
        if self.kind == KIND_END_HEIGHT:
            out += pe.varint_field(3, self.height)
        else:
            out += pe.bytes_field(4, self.data)
        return out

    @classmethod
    def decode(cls, raw: bytes) -> "WALRecord":
        r = pe.Reader(raw)
        kind, time_ns, height, data = KIND_MESSAGE, 0, 0, b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kind = r.read_uvarint()
            elif f == 2:
                time_ns = r.read_uvarint()
            elif f == 3:
                height = r.read_uvarint()
            elif f == 4:
                data = r.read_bytes()
            else:
                r.skip(wt)
        return cls(kind, time_ns, data, height)


class WALCorruptionError(RuntimeError):
    pass


@dataclass(frozen=True)
class WALRepair:
    """One repaired file: everything past `valid_end` was moved aside."""

    path: str
    valid_end: int  # byte offset of the last whole record
    file_size: int  # size before repair
    n_records: int  # whole records surviving in this file
    tail_path: str  # where the damaged tail went
    reason: str  # what broke the frame walk


class WAL:
    def __init__(
        self,
        directory: str,
        *,
        head_size_limit: int = 10 * 1024 * 1024,
        total_size_limit: int = 1024 * 1024 * 1024,
        fs: FS | None = None,
        logger: logging.Logger | None = None,
    ):
        self.dir = directory
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self.fs = fs or REAL_FS
        self.logger = logger or logging.getLogger("wal")
        self.fs.makedirs(directory)
        self._head_path = os.path.join(directory, "wal")
        # heal any crash damage BEFORE appending: writing after a torn
        # tail would bury the corruption mid-file and silently drop every
        # later record at replay
        self.last_repair: list[WALRepair] = self.repair()
        self._f = self.fs.open(self._head_path, "ab")

    # -- writing ---------------------------------------------------------

    def _write_record(self, rec: WALRecord, sync: bool) -> None:
        payload = rec.encode()
        if len(payload) > MAX_RECORD_SIZE:
            raise ValueError("WAL record too big")
        frame = _FRAME.pack(zlib.crc32(payload), len(payload))
        start = self._f.tell()
        try:
            self._f.write(frame + payload)
        except OSError:
            # ENOSPC (or any I/O error) mid-record: roll the partial frame
            # back so the head never grows an unframed garbage gap. Best
            # effort — if even the truncate fails, repair() heals it at
            # the next open.
            try:
                self._f.flush()
            except OSError:
                pass
            try:
                self._f.truncate(start)
                self._f.seek(start)
            except OSError:
                pass
            raise
        if sync:
            self.fs.fsync(self._f)
        if self._f.tell() >= self.head_size_limit:
            self._rotate()

    def write(self, data: bytes, time_ns: int = 0) -> None:
        """Buffered write (group-flushed; reference wal.go Write)."""
        self._write_record(WALRecord(KIND_MESSAGE, time_ns, data), sync=False)

    def write_sync(self, data: bytes, time_ns: int = 0) -> None:
        """Fsync'd write — used for messages about to be acted on
        (reference wal.go WriteSync)."""
        self._write_record(WALRecord(KIND_MESSAGE, time_ns, data), sync=True)

    def write_end_height(self, height: int) -> None:
        self._write_record(WALRecord(KIND_END_HEIGHT, 0, b"", height), sync=True)

    def flush(self) -> None:
        self.fs.fsync(self._f)

    def close(self) -> None:
        try:
            self.flush()
        except (OSError, ValueError):
            pass
        self._f.close()

    # -- rotation --------------------------------------------------------

    def _rotated_files(self) -> list[str]:
        names = sorted(
            (n for n in self.fs.listdir(self.dir) if n.startswith("wal.") and n[4:].isdigit()),
            key=lambda n: int(n[4:]),
        )
        return [os.path.join(self.dir, n) for n in names]

    def _rotate(self) -> None:
        self._f.flush()
        self._f.close()
        existing = self._rotated_files()
        idx = (
            int(os.path.basename(existing[-1])[4:]) + 1 if existing else 0
        )
        self.fs.rename(self._head_path, os.path.join(self.dir, f"wal.{idx:03d}"))
        self._f = self.fs.open(self._head_path, "ab")
        # enforce the group size cap by dropping the oldest rotated file
        files = self._rotated_files()
        total = sum(self.fs.getsize(p) for p in files) + self._f.tell()
        while files and total > self.total_size_limit:
            total -= self.fs.getsize(files[0])
            self.fs.remove(files.pop(0))

    # -- reading ---------------------------------------------------------

    def _all_files(self) -> list[str]:
        files = self._rotated_files()
        if self.fs.exists(self._head_path):
            files.append(self._head_path)
        return files

    def _note_corrupt(self, path: str, offset: int, reason: str) -> None:
        record_storage("wal_corrupt_records")
        self.logger.warning(
            "WAL corruption: %s in %s at offset %d (replay truncated here)",
            reason, path, offset,
        )

    def iter_records(self, *, strict: bool = False) -> Iterator[WALRecord]:
        """Replay all records oldest-first. A torn tail frame (crash during
        write) terminates iteration; corruption mid-log raises in strict
        mode (reference WALDecoder semantics). Non-strict truncation is
        never silent: it bumps the `wal_corrupt_records` metric and logs
        the file/offset."""
        if getattr(self, "_f", None) is not None and not self._f.closed:
            self._f.flush()
        for path in self._all_files():
            with self.fs.open(path, "rb") as f:
                is_head = path == self._head_path
                while True:
                    at = f.tell()
                    frame = f.read(_FRAME.size)
                    if not frame:
                        break
                    if len(frame) < _FRAME.size:
                        if strict and not is_head:
                            raise WALCorruptionError(f"torn frame in {path}")
                        self._note_corrupt(path, at, "torn frame")
                        return
                    crc, length = _FRAME.unpack(frame)
                    if length > MAX_RECORD_SIZE:
                        if strict:
                            raise WALCorruptionError(f"oversized record in {path}")
                        self._note_corrupt(path, at, "oversized record")
                        return
                    payload = f.read(length)
                    if len(payload) < length:
                        if strict and not is_head:
                            raise WALCorruptionError(f"torn payload in {path}")
                        self._note_corrupt(path, at, "torn payload")
                        return
                    if zlib.crc32(payload) != crc:
                        if strict:
                            raise WALCorruptionError(f"CRC mismatch in {path}")
                        self._note_corrupt(path, at, "CRC mismatch")
                        return
                    yield WALRecord.decode(payload)

    # -- crash repair ----------------------------------------------------

    def _scan_valid(self, path: str) -> tuple[int, int, str]:
        """Walk frames; return (offset past the last whole record, count
        of whole records, reason the walk stopped)."""
        valid_end = 0
        n = 0
        with self.fs.open(path, "rb") as f:
            while True:
                frame = f.read(_FRAME.size)
                if not frame:
                    return valid_end, n, "eof"
                if len(frame) < _FRAME.size:
                    return valid_end, n, "torn frame"
                crc, length = _FRAME.unpack(frame)
                if length > MAX_RECORD_SIZE:
                    return valid_end, n, "oversized record"
                payload = f.read(length)
                if len(payload) < length:
                    return valid_end, n, "torn payload"
                if zlib.crc32(payload) != crc:
                    return valid_end, n, "CRC mismatch"
                valid_end = f.tell()
                n += 1

    def repair(self) -> list[WALRepair]:
        """Truncate every WAL file to its last whole record, moving the
        damaged tail aside as `<file>.corrupt.<n>` (never deleted — it is
        forensic evidence, and `wal.corrupt.*` names are invisible to the
        rotation scan). ALL files are scanned, not just the newest:
        lost-but-acked fsyncs mean even rotated files can carry torn
        tails (the durable watermark travels with the rename), and an
        unrepaired mid-log tear would silently drop every later record
        at replay. The cost is one extra CRC pass over the WAL — the
        same order as the `iter_records` replay that follows on every
        restart anyway. Returns one `WALRepair` per healed file; the
        caller (consensus/replay.report_wal_repair) logs the truncation
        points."""
        repairs: list[WALRepair] = []
        for path in self._all_files():
            size = self.fs.getsize(path)
            valid_end, n, reason = self._scan_valid(path)
            if valid_end >= size:
                continue
            # confirm before destroying: a transient read error (bit-rot
            # injection, flaky medium) must not truncate records that are
            # intact on disk — re-scan and keep the furthest clean walk
            valid_end2, n2, reason2 = self._scan_valid(path)
            if valid_end2 >= size:
                continue  # first scan's corruption was a transient read
            if valid_end2 > valid_end:
                valid_end, n, reason = valid_end2, n2, reason2
            # salvage the damaged tail before truncating — best-effort:
            # it is forensic evidence, and a full disk (ENOSPC) must not
            # turn a post-crash restart into a startup failure
            k = 0
            while self.fs.exists(f"{path}.corrupt.{k}"):
                k += 1
            tail_path = f"{path}.corrupt.{k}"
            try:
                with self.fs.open(path, "rb") as src:
                    src.seek(valid_end)
                    tail = src.read(size - valid_end)
                with self.fs.open(tail_path, "wb") as dst:
                    dst.write(tail)
                    self.fs.fsync(dst)
            except OSError as e:
                self.logger.warning(
                    "WAL repair: could not salvage damaged tail of %s "
                    "to %s (%r); truncating anyway", path, tail_path, e,
                )
                try:
                    if self.fs.exists(tail_path):
                        self.fs.remove(tail_path)  # no partial salvage litter
                except OSError:
                    pass
                tail_path = ""
            self.fs.truncate(path, valid_end)
            record_storage("wal_repairs")
            record_storage("wal_truncated_bytes", size - valid_end)
            rep = WALRepair(path, valid_end, size, n, tail_path, reason)
            repairs.append(rep)
            self.logger.warning(
                "WAL repair: %s at %s:%d — truncated %d damaged byte(s) to "
                "the last whole record (#%d), tail saved to %s",
                reason, path, valid_end, size - valid_end, n, tail_path,
            )
        return repairs

    def search_for_end_height(self, height: int) -> list[WALRecord] | None:
        """Messages recorded after `#ENDHEIGHT: height` (reference
        wal.go:231 SearchForEndHeight) — i.e. everything belonging to
        height+1. Returns None if the marker is absent. Height 0 matches
        the start of the log (fresh chain)."""
        if height == 0:
            found = True
            out: list[WALRecord] = []
        else:
            found = False
            out = []
        for rec in self.iter_records():
            if rec.kind == KIND_END_HEIGHT:
                if rec.height == height:
                    found = True
                    out = []
                elif found and rec.height > height:
                    # next height completed too; keep collecting — replay
                    # handles duplicates idempotently
                    pass
                continue
            if found:
                out.append(rec)
        return out if found else None
