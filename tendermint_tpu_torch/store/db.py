"""Key-value database abstraction (the analog of tm-db used throughout the
reference: block store, state store, evidence pool, indexer all take a DB).

Two implementations: `MemDB` (tests, in-memory transports) and `SQLiteDB`
(durable single-file store, stdlib sqlite3 — the image has no leveldb).
Both support atomic write batches and ordered iteration, which the stores
rely on for height-keyed scans and pruning."""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator


class DB:
    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterate(
        self, start: bytes = b"", end: bytes | None = None, reverse: bool = False
    ) -> Iterator[tuple[bytes, bytes]]:
        """Ordered scan over keys in [start, end)."""
        raise NotImplementedError

    def write_batch(self, sets: list[tuple[bytes, bytes]], deletes: list[bytes] = ()):
        """Atomically apply sets then deletes."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(DB):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(key, None)

    def iterate(self, start=b"", end=None, reverse=False):
        with self._lock:
            keys = sorted(
                k for k in self._data if k >= start and (end is None or k < end)
            )
        if reverse:
            keys.reverse()
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def write_batch(self, sets, deletes=()):
        with self._lock:
            for k, v in sets:
                self._data[k] = v
            for k in deletes:
                self._data.pop(k, None)


class SQLiteDB(DB):
    """Durable KV store; WAL journal mode so reads don't block the writer."""

    def __init__(self, path: str):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value)
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def iterate(self, start=b"", end=None, reverse=False):
        order = "DESC" if reverse else "ASC"
        if end is None:
            q = f"SELECT k, v FROM kv WHERE k >= ? ORDER BY k {order}"
            args: tuple = (start,)
        else:
            q = f"SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k {order}"
            args = (start, end)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def write_batch(self, sets, deletes=()):
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", list(sets)
            )
            if deletes:
                self._conn.executemany(
                    "DELETE FROM kv WHERE k = ?", [(k,) for k in deletes]
                )
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
