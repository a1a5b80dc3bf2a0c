"""PartSet — blocks split into 64 KB merkle-proved parts for gossip
(reference types/part_set.go; the port's copy of
tendermint_tpu/types/part_set.py). A proposer splits the encoded block; peers
reassemble parts in any order, each carrying an inclusion proof against the
PartSetHeader hash."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle
from ..libs import protoenc as pe
from ..libs.bits import BitArray
from .block import PartSetHeader
from .keys import BLOCK_PART_SIZE


@dataclass(frozen=True)
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def leaf_hash(self) -> bytes:
        """SHA-256(0x00||bytes_), computed once and cached: receive-side
        proof verification and any re-gossip reuse one derivation
        instead of re-hashing the 64 KB payload per consumer. Safe on
        the frozen dataclass — bytes_ never changes."""
        cached = self.__dict__.get("_leaf_hash")
        if cached is None:
            from ..crypto import hash_hub

            cached = hash_hub.sha256_one(
                merkle.LEAF_PREFIX + self.bytes_, lane=hash_hub.LANE_VERIFY
            )
            self.__dict__["_leaf_hash"] = cached
        return cached

    def encode(self) -> bytes:
        out = pe.varint_field(1, self.index + 1)
        out += pe.bytes_field(2, self.bytes_)
        out += pe.message_field(3, self.proof.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Part":
        r = pe.Reader(data)
        index, bytes_, proof = 0, b"", merkle.Proof(0, 0, b"", [])
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                index = r.read_uvarint() - 1
            elif f == 2:
                bytes_ = r.read_bytes()
            elif f == 3:
                proof = merkle.Proof.decode(r.read_bytes())
            else:
                r.skip(wt)
        return cls(index, bytes_, proof)


class PartSet:
    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        from ..crypto import hash_hub

        chunks = [data[i : i + part_size] for i in range(0, len(data), part_size)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(
            chunks, lane=hash_hub.LANE_BUILD
        )
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        # install directly: this process just BUILT the tree, so
        # re-verifying every proof through add_part would re-derive each
        # leaf hash from the 64 KB chunk it was computed from one line
        # up. Receive-side parts still take the verifying add_part path.
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            part = Part(i, chunk, proof)
            part.__dict__["_leaf_hash"] = proof.leaf_hash
            ps.parts[i] = part
            ps.parts_bit_array.set(i, True)
            ps.count += 1
            ps.byte_size += len(chunk)
        return ps

    def __init__(self, header: PartSetHeader):
        self.header = header
        self.parts: list[Part | None] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self.count = 0
        self.byte_size = 0

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof and slot it in. Returns False for
        duplicates; raises on invalid proofs."""
        if not 0 <= part.index < self.header.total:
            raise ValueError(f"part index {part.index} out of range")
        if self.parts[part.index] is not None:
            return False
        if part.proof.index != part.index or part.proof.total != self.header.total:
            raise ValueError("part proof position mismatch")
        # the cached leaf hash is derived from part.bytes_ itself, so
        # passing it only skips the re-derivation, not the check
        if not part.proof.verify(
            self.header.hash, part.bytes_, leaf_hash=part.leaf_hash()
        ):
            raise ValueError("invalid part proof")
        self.parts[part.index] = part
        self.parts_bit_array.set(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, idx: int) -> Part | None:
        if 0 <= idx < len(self.parts):
            return self.parts[idx]
        return None

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise ValueError("incomplete part set")
        return b"".join(p.bytes_ for p in self.parts)
