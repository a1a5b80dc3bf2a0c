"""RFC 6962 merkle tree (the port's copy of tendermint_tpu/crypto/merkle.py;
reference crypto/merkle/tree.go, proof.go).

Leaf hash = SHA-256(0x00 || leaf), inner hash = SHA-256(0x01 || left || right),
empty tree hash = SHA-256(""). Trees are unbalanced with the split at the
largest power of two strictly less than n.

Tree construction is level-order through the HashHub: each level of the
tree is one `hash_hub.sha256_many` batch. The level-order pass pairs
nodes left to right and promotes an odd last node unhashed, which gives
the same roots and proofs as the recursive largest-power-of-two-split
builder. The reference's scalar recursive builders (its
`use_hashhub(False)` kill switch) are not ported."""

from __future__ import annotations

from dataclasses import dataclass

from .hash_hub import sha256_many as _sha256_many
from .hashes import sha256

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"

# Proofs arrive from untrusted peers (light client, statesync): depth is
# logarithmic in tree size, so anything past 100 aunts (reference
# crypto/merkle/proof.go MaxAunts, a 2^100-leaf tree) is malformed by
# construction — raise at decode, never allocate (tmtlint wire-bounds).
MAX_PROOF_AUNTS = 100


def _leaf_hash(leaf: bytes) -> bytes:
    return sha256(LEAF_PREFIX + leaf)


def _inner_hash(left: bytes, right: bytes) -> bytes:
    return sha256(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: list[bytes], *, lane: str | None = None) -> bytes:
    """Root hash of the merkle tree over `items` (reference crypto/merkle/tree.go:11).

    Level-order batched through the HashHub; `lane` tags the hub
    accounting (ambient `hash_hub.lane_ctx` when omitted)."""
    n = len(items)
    if n == 0:
        return sha256(b"")
    level = _sha256_many([LEAF_PREFIX + it for it in items], lane=lane)
    while len(level) > 1:
        odd = len(level) & 1
        pair = iter(level)
        nxt = _sha256_many(
            [INNER_PREFIX + a + b for a, b in zip(pair, pair)], lane=lane
        )
        if odd:
            nxt.append(level[-1])
        level = nxt
    return level[0]


@dataclass
class Proof:
    """Inclusion proof for item `index` of `total` with sibling hashes
    root-ward in `aunts` (reference crypto/merkle/proof.go:26)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]

    def verify(
        self, root: bytes, leaf: bytes, *, leaf_hash: bytes | None = None
    ) -> bool:
        """`leaf_hash`, when given, must be SHA-256(0x00||leaf) computed
        by the CALLER from the same bytes (the part-set receive path
        caches it on the Part) — it skips the redundant re-derivation,
        not the check against the proof's pinned leaf hash."""
        if self.total < 0 or not 0 <= self.index < max(self.total, 1):
            return False
        if (leaf_hash if leaf_hash is not None else _leaf_hash(leaf)) != self.leaf_hash:
            return False
        computed = _compute_root(self.leaf_hash, self.index, self.total, self.aunts)
        return computed == root

    def encode(self) -> bytes:
        from ..libs import protoenc as pe

        out = pe.varint_field(1, self.total) + pe.varint_field(2, self.index)
        out += pe.bytes_field(3, self.leaf_hash)
        for a in self.aunts:
            out += pe.message_field(4, a)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Proof":
        from ..libs import protoenc as pe

        r = pe.Reader(data)
        total = index = 0
        leaf_hash = b""
        aunts: list[bytes] = []
        while not r.eof():
            field, wt = r.read_tag()
            if field == 1:
                total = r.read_uvarint()
            elif field == 2:
                index = r.read_uvarint()
            elif field == 3:
                leaf_hash = r.read_bytes()
            elif field == 4:
                aunts.append(r.read_bytes())
                if len(aunts) > MAX_PROOF_AUNTS:
                    raise ValueError(
                        f"merkle proof aunts exceed {MAX_PROOF_AUNTS}"
                    )
            else:
                r.skip(wt)
        return cls(total=total, index=index, leaf_hash=leaf_hash, aunts=aunts)


def _compute_root(leaf_hash: bytes, index: int, total: int, aunts: list[bytes]) -> bytes | None:
    if total == 0:
        return None
    if total == 1:
        return leaf_hash if not aunts else None
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_root(leaf_hash, index, k, aunts[:-1])
        if left is None:
            return None
        return _inner_hash(left, aunts[-1])
    right = _compute_root(leaf_hash, index - k, total - k, aunts[:-1])
    if right is None:
        return None
    return _inner_hash(aunts[-1], right)


def proofs_from_byte_slices(
    items: list[bytes], *, lane: str | None = None
) -> tuple[bytes, list[Proof]]:
    """Build the tree and an inclusion proof per item.

    Level-order like `hash_from_byte_slices`: leaf positions are
    tracked up the tree (sibling = pos^1 while the node is paired at
    this level; a promoted odd-last ancestor contributes no aunt), so
    aunts come out nearest-first — the same order the recursive builder
    produces as its recursion unwinds."""
    n = len(items)
    if n == 0:
        return sha256(b""), []
    leaf_hashes = _sha256_many([LEAF_PREFIX + it for it in items], lane=lane)
    aunts: list[list[bytes]] = [[] for _ in range(n)]
    pos = list(range(n))  # pos[i]: index of leaf i's ancestor in `level`
    level = leaf_hashes
    while len(level) > 1:
        paired = len(level) & ~1
        for i in range(n):
            p = pos[i]
            if p < paired:
                aunts[i].append(level[p ^ 1])
                pos[i] = p >> 1
            else:  # promoted unhashed — no aunt at this level
                pos[i] = paired >> 1
        pair = iter(level)
        nxt = _sha256_many(
            [INNER_PREFIX + a + b for a, b in zip(pair, pair)], lane=lane
        )
        if len(level) > paired:
            nxt.append(level[-1])
        level = nxt
    proofs = [
        Proof(total=n, index=i, leaf_hash=leaf_hashes[i], aunts=aunts[i])
        for i in range(n)
    ]
    return level[0], proofs


# -- proof operators ---------------------------------------------------------
#
# Reference crypto/merkle/proof_op.go + proof_value.go: an abci_query proof
# is a CHAIN of typed operators — each op maps (key-path segment, value) to
# the next layer's root, the last op's output must equal the header's
# app_hash. The light RPC client uses this to verify query results it did
# not compute itself.


@dataclass
class ProofOp:
    """One operator: `type_` selects the verifier, `key` is the key-path
    segment it consumes, `data` its encoded proof payload."""

    type_: str
    key: bytes
    data: bytes

    def encode(self) -> bytes:
        from ..libs import protoenc as pe

        return (
            pe.string_field(1, self.type_)
            + pe.bytes_field(2, self.key)
            + pe.bytes_field(3, self.data)
        )

    @classmethod
    def decode(cls, raw: bytes) -> "ProofOp":
        from ..libs import protoenc as pe

        r = pe.Reader(raw)
        type_, key, data = "", b"", b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                type_ = r.read_bytes().decode()
            elif f == 2:
                key = r.read_bytes()
            elif f == 3:
                data = r.read_bytes()
            else:
                r.skip(wt)
        return cls(type_, key, data)


PROOF_OP_VALUE = "tmtpu:value"


def value_op(key: bytes, proof: Proof) -> ProofOp:
    """Key/value inclusion under a merkle-rooted KV store: the leaf is the
    deterministic (key, value) pair encoding (reference proof_value.go
    ValueOp, with sha256(value) folded into the leaf encoding here)."""
    return ProofOp(PROOF_OP_VALUE, key, proof.encode())


def kv_leaf(key: bytes, value: bytes) -> bytes:
    from ..libs import protoenc as pe

    return pe.bytes_field(1, key) + pe.bytes_field(2, value)


def _verify_value_op(op: ProofOp, root: bytes, value: bytes) -> bool:
    try:
        proof = Proof.decode(op.data)
    except Exception:
        return False
    return proof.verify(root, kv_leaf(op.key, value))


_OP_VERIFIERS = {PROOF_OP_VALUE: _verify_value_op}


class ProofOperators:
    """Verify a chain of proof ops against an expected root and key path
    (reference proof_op.go ProofOperators.Verify). The key path is
    '/seg1/seg2/…' with URL-escaped segments, consumed right-to-left as
    ops are applied bottom-up; this framework's apps use single-op paths."""

    def __init__(self, ops: list[ProofOp]):
        self.ops = list(ops)

    def verify_value(self, root: bytes, keypath: str, value: bytes) -> bool:
        from urllib.parse import unquote_to_bytes

        segments = [
            unquote_to_bytes(s) for s in keypath.split("/") if s != ""
        ]
        if len(segments) < len(self.ops):
            return False
        current = value
        for i, op in enumerate(self.ops):
            verifier = _OP_VERIFIERS.get(op.type_)
            if verifier is None:
                return False
            expect_key = segments[len(segments) - 1 - i]
            if op.key != expect_key:
                return False
            if i == len(self.ops) - 1:
                return verifier(op, root, current)
            # multi-op chains: intermediate ops must yield the next root —
            # represented by the op's own computed root carried as `current`
            try:
                proof = Proof.decode(op.data)
            except Exception:
                return False
            current = _compute_root(
                _leaf_hash(kv_leaf(op.key, current)),
                proof.index,
                proof.total,
                proof.aunts,
            )
        return False


def key_path(*segments: bytes) -> str:
    from urllib.parse import quote_from_bytes

    return "/" + "/".join(quote_from_bytes(s) for s in segments)
