"""BitArray — thread-compatible bit vector used for vote bookkeeping and
block-part tracking (analog of reference libs/bits/bit_array.go)."""

from __future__ import annotations

import secrets

# bit offsets set in each possible byte value (true_indices hot loop)
_BYTE_BITS = tuple(
    tuple(i for i in range(8) if b >> i & 1) for b in range(256)
)


class BitArray:
    __slots__ = ("size", "_bits")

    # Hard allocation cap. Legitimate arrays track validators (hundreds)
    # or block parts (thousands); sizes arrive from the WIRE in several
    # gossip messages (vote-set bits, part-set headers, has-vote growth),
    # so without a cap one corrupt varint is a multi-GiB bytearray
    # allocation — a remote memory bomb. Oversize raises ValueError,
    # which the reactors attribute to the sending peer.
    MAX_SIZE = 1 << 24

    def __init__(self, size: int):
        if size < 0:
            raise ValueError("negative BitArray size")
        if size > self.MAX_SIZE:
            raise ValueError(
                f"BitArray size {size} exceeds MAX_SIZE {self.MAX_SIZE}"
            )
        self.size = size
        self._bits = bytearray((size + 7) // 8)

    @classmethod
    def from_indices(cls, size: int, indices) -> "BitArray":
        ba = cls(size)
        for i in indices:
            ba.set(i, True)
        return ba

    def get(self, i: int) -> bool:
        if not 0 <= i < self.size:
            return False
        return bool(self._bits[i >> 3] & (1 << (i & 7)))

    def set(self, i: int, value: bool) -> bool:
        if not 0 <= i < self.size:
            return False
        if value:
            self._bits[i >> 3] |= 1 << (i & 7)
        else:
            self._bits[i >> 3] &= ~(1 << (i & 7))
        return True

    def copy(self) -> "BitArray":
        ba = BitArray(self.size)
        ba._bits = bytearray(self._bits)
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        out = BitArray(max(self.size, other.size))
        for i in range(len(out._bits)):
            a = self._bits[i] if i < len(self._bits) else 0
            b = other._bits[i] if i < len(other._bits) else 0
            out._bits[i] = a | b
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.size, other.size))
        for i in range(len(out._bits)):
            out._bits[i] = self._bits[i] & other._bits[i]
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.size)
        for i in range(len(out._bits)):
            out._bits[i] = ~self._bits[i] & 0xFF
        # clear padding bits beyond size
        extra = len(out._bits) * 8 - out.size
        if extra:
            out._bits[-1] &= 0xFF >> extra
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other."""
        out = self.copy()
        n = min(len(self._bits), len(other._bits))
        for i in range(n):
            out._bits[i] &= ~other._bits[i] & 0xFF
        return out

    def is_empty(self) -> bool:
        return not any(self._bits)

    def is_full(self) -> bool:
        if self.size == 0:
            return True
        full, extra = divmod(self.size, 8)
        if any(b != 0xFF for b in self._bits[:full]):
            return False
        if extra:
            return self._bits[full] == (0xFF >> (8 - extra))
        return True

    def pick_random(self) -> int | None:
        """Pick a uniformly random set bit index, or None if empty."""
        ones = self.true_indices()
        if not ones:
            return None
        return ones[secrets.randbelow(len(ones))]

    def true_indices(self) -> list[int]:
        """Set bit indices, byte-at-a-time via a 256-entry offset table.
        This is the consensus gossip hot loop — every vote-gossip tick
        diffs vote sets and walks the result, so the naive per-bit
        `get()` walk (8 calls per byte) dominated committee-scale
        profiles (24M get() calls in a 90s window at 150 validators)."""
        out: list[int] = []
        bits = self._bits
        byte_bits = _BYTE_BITS
        for byte_i, b in enumerate(bits):
            if b:
                base = byte_i << 3
                out.extend(base + off for off in byte_bits[b])
        # wire-decoded arrays (from_bytes) may carry garbage padding
        # bits beyond `size`; everything else keeps padding clear
        while out and out[-1] >= self.size:
            out.pop()
        return out

    def num_true(self) -> int:
        return sum(bin(b).count("1") for b in self._bits)

    def to_bytes(self) -> bytes:
        return bytes(self._bits)

    @classmethod
    def from_bytes(cls, size: int, data: bytes) -> "BitArray":
        ba = cls(size)
        ba._bits[: len(data)] = data[: len(ba._bits)]
        return ba

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.size == other.size
            and self._bits == other._bits
        )

    def __repr__(self) -> str:
        s = "".join("x" if self.get(i) else "_" for i in range(min(self.size, 64)))
        return f"BitArray{{{s}{'…' if self.size > 64 else ''}}}"
