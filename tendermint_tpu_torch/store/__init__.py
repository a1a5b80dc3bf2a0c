"""Persistence layer: KV DBs and the block store (reference internal/store/)."""

from .blockstore import BlockMeta, BlockStore
from .db import DB, MemDB, SQLiteDB

__all__ = ["BlockMeta", "BlockStore", "DB", "MemDB", "SQLiteDB"]
