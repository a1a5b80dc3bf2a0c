"""Block store (reference internal/store/store.go:33).

Persists blocks by height as parts (the gossip unit), plus per-height
commits: the canonical commit (carried in the next block's LastCommit) and
the locally-seen commit (may differ in round/timestamps). Heights are
fixed-width big-endian in keys so ordered DB scans walk the chain."""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..libs import protoenc as pe
from ..types.block import Block, BlockID, Commit, Header
from ..types.part_set import Part, PartSet
from .db import DB


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


_META = b"H:"
_PART = b"P:"
_COMMIT = b"C:"
_SEEN = b"SC:"
_HASH = b"BH:"
_STATE = b"blockStore"


@dataclass(frozen=True)
class BlockMeta:
    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def encode(self) -> bytes:
        return (
            pe.message_field(1, self.block_id.encode())
            + pe.varint_field(2, self.block_size)
            + pe.message_field(3, self.header.encode())
            + pe.varint_field(4, self.num_txs)
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockMeta":
        r = pe.Reader(data)
        bid, size, header, ntx = BlockID(), 0, Header(), 0
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                bid = BlockID.decode(r.read_bytes())
            elif f == 2:
                size = r.read_uvarint()
            elif f == 3:
                header = Header.decode(r.read_bytes())
            elif f == 4:
                ntx = r.read_uvarint()
            else:
                r.skip(wt)
        return cls(bid, size, header, ntx)


class BlockStore:
    def __init__(self, db: DB):
        self.db = db
        self._lock = threading.Lock()
        self._base, self._height = self._load_state()

    def _load_state(self) -> tuple[int, int]:
        raw = self.db.get(_STATE)
        if raw is None:
            return 0, 0
        r = pe.Reader(raw)
        base = height = 0
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                base = r.read_uvarint()
            elif f == 2:
                height = r.read_uvarint()
            else:
                r.skip(wt)
        return base, height

    def _save_state(self, sets: list) -> None:
        sets.append(
            (_STATE, pe.varint_field(1, self._base) + pe.varint_field(2, self._height))
        )

    def base(self) -> int:
        return self._base

    def height(self) -> int:
        return self._height

    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit) -> None:
        height = block.header.height
        with self._lock:
            if self._height and height != self._height + 1:
                raise ValueError(
                    f"non-contiguous block save: have {self._height}, got {height}"
                )
            block_id = BlockID(block.hash(), part_set.header)
            meta = BlockMeta(block_id, len(block.encode()), block.header, len(block.txs))
            sets: list[tuple[bytes, bytes]] = [
                (_hkey(_META, height), meta.encode()),
                (_HASH + block.hash(), height.to_bytes(8, "big")),
                (_hkey(_SEEN, height), seen_commit.encode()),
            ]
            for i in range(part_set.header.total):
                part = part_set.get_part(i)
                assert part is not None, "saving incomplete part set"
                sets.append((_hkey(_PART, height) + i.to_bytes(4, "big"), part.encode()))
            if block.last_commit is not None:
                sets.append((_hkey(_COMMIT, height - 1), block.last_commit.encode()))
            self._height = height
            if self._base == 0:
                self._base = height
            self._save_state(sets)
            self.db.write_batch(sets)

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self.db.set(_hkey(_SEEN, height), commit.encode())

    def bootstrap(self, height: int) -> None:
        """State-sync bootstrap: position the store at `height` without
        any blocks, so block-sync/consensus continue from height+1
        (reference store.go SaveSeenCommit + state bootstrap path)."""
        with self._lock:
            if self._height != 0:
                raise ValueError("bootstrap on a non-empty block store")
            self._base = height + 1
            self._height = height
            self._save_state([])

    def save_signed_header(self, header, commit: Commit, block_id: BlockID) -> None:
        """Store a backfilled header+commit without block data (statesync
        Backfill, reference reactor.go:348): enough for evidence
        verification and light-block serving, below the store base."""
        meta = BlockMeta(block_id, 0, header, 0)
        sets = [
            (_hkey(_META, header.height), meta.encode()),
            (_HASH + header.hash(), header.height.to_bytes(8, "big")),
            (_hkey(_COMMIT, header.height), commit.encode()),
        ]
        self.db.write_batch(sets)

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self.db.get(_hkey(_META, height))
        return BlockMeta.decode(raw) if raw is not None else None

    def load_block(self, height: int) -> Block | None:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        data = []
        for i in range(meta.block_id.part_set_header.total):
            raw = self.db.get(_hkey(_PART, height) + i.to_bytes(4, "big"))
            if raw is None:
                return None
            data.append(Part.decode(raw).bytes_)
        return Block.decode(b"".join(data))

    def load_block_by_hash(self, hash_: bytes) -> Block | None:
        raw = self.db.get(_HASH + hash_)
        if raw is None:
            return None
        return self.load_block(int.from_bytes(raw, "big"))

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self.db.get(_hkey(_PART, height) + index.to_bytes(4, "big"))
        return Part.decode(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit for `height` (from block height+1's LastCommit)."""
        raw = self.db.get(_hkey(_COMMIT, height))
        return Commit.decode(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self.db.get(_hkey(_SEEN, height))
        return Commit.decode(raw) if raw is not None else None

    def prune_blocks(self, retain_height: int) -> int:
        """Drop blocks below retain_height (reference store.go:287). Keeps
        the commit for retain_height-1 (needed to verify retain_height)."""
        with self._lock:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height + 1:
                raise ValueError("cannot prune beyond store height")
            pruned = 0
            deletes: list[bytes] = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_hkey(_META, h))
                deletes.append(_HASH + meta.block_id.hash)
                deletes.append(_hkey(_SEEN, h))
                if h < retain_height - 1:
                    deletes.append(_hkey(_COMMIT, h))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_hkey(_PART, h) + i.to_bytes(4, "big"))
                pruned += 1
            self._base = retain_height
            sets: list[tuple[bytes, bytes]] = []
            self._save_state(sets)
            self.db.write_batch(sets, deletes)
            return pruned
