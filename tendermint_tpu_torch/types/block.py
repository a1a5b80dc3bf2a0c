"""Block, Header, Commit, CommitSig, BlockID, PartSetHeader (the port's
copy of tendermint_tpu/types/block.py).

Structural analog of reference types/block.go. All hashes are RFC-6962
merkle roots over deterministic field encodings (libs/protoenc); every type
has encode()/decode() used for storage, gossip, and hashing — there is no
separate "proto" layer, the canonical encoding IS the wire format.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..crypto.hashes import HASH_SIZE
from ..crypto import merkle
from ..libs import protoenc as pe
from .canonical import vote_sign_bytes, encode_timestamp
from .keys import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    SignedMsgType,
)

# Wire-side sanity bounds. Blocks and commits arrive from untrusted
# peers (block-sync, catch-up gossip, light provider responses) and the
# chaos matrix corrupts frames that still parse — a flipped repeat
# count must raise at decode, never allocate (tmtlint wire-bounds).
# Validator sets are ≤ a few hundred in practice; 2^16 signatures and
# 2^20 txs/evidence items are malformed by construction.
MAX_WIRE_COMMIT_SIGS = 1 << 16
MAX_WIRE_BLOCK_TXS = 1 << 20
MAX_WIRE_BLOCK_EVIDENCE = 1 << 16


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        return pe.varint_field(1, self.total) + pe.bytes_field(2, self.hash)

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        r = pe.Reader(data)
        total, hash_ = 0, b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                total = r.read_uvarint()
            elif f == 2:
                hash_ = r.read_bytes()
            else:
                r.skip(wt)
        return cls(total, hash_)

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative part-set total")
        if self.hash and len(self.hash) != HASH_SIZE:
            raise ValueError("bad part-set hash size")


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == HASH_SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == HASH_SIZE
        )

    def key(self) -> bytes:
        return self.hash + self.part_set_header.encode()

    def encode(self) -> bytes:
        return pe.bytes_field(1, self.hash) + pe.message_field(
            2, self.part_set_header.encode()
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        r = pe.Reader(data)
        hash_, psh = b"", PartSetHeader()
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                hash_ = r.read_bytes()
            elif f == 2:
                psh = PartSetHeader.decode(r.read_bytes())
            else:
                r.skip(wt)
        return cls(hash_, psh)

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != HASH_SIZE:
            raise ValueError("bad block hash size")
        self.part_set_header.validate_basic()


NIL_BLOCK_ID = BlockID()


@dataclass(frozen=True)
class CommitSig:
    """One validator's precommit inside a Commit (reference types/block.go
    CommitSig). flag: absent (no vote seen), commit (voted for the block),
    nil (voted nil)."""

    flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    @classmethod
    def for_block(cls, addr: bytes, ts: int, sig: bytes) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_COMMIT, addr, ts, sig)

    @classmethod
    def for_nil(cls, addr: bytes, ts: int, sig: bytes) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_NIL, addr, ts, sig)

    def is_absent(self) -> bool:
        return self.flag == BLOCK_ID_FLAG_ABSENT

    def is_commit(self) -> bool:
        return self.flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this signature attests to (reference types/block.go
        CommitSig.BlockID)."""
        return commit_block_id if self.flag == BLOCK_ID_FLAG_COMMIT else NIL_BLOCK_ID

    def encode(self) -> bytes:
        out = pe.varint_field(1, self.flag)
        out += pe.bytes_field(2, self.validator_address)
        out += pe.message_field(3, encode_timestamp(self.timestamp_ns))
        out += pe.bytes_field(4, self.signature)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "CommitSig":
        r = pe.Reader(data)
        flag, addr, ts, sig = BLOCK_ID_FLAG_ABSENT, b"", 0, b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                flag = r.read_uvarint()
            elif f == 2:
                addr = r.read_bytes()
            elif f == 3:
                ts = _decode_timestamp(r.read_bytes())
            elif f == 4:
                sig = r.read_bytes()
            else:
                r.skip(wt)
        return cls(flag, addr, ts, sig)

    def validate_basic(self, *, aggregate: bool = False) -> None:
        """`aggregate=True` validates the entry as part of an aggregate
        commit: the per-validator signature lives in the commit-level
        aggregate, so it must be EMPTY here (flag/address/timestamp
        rules are unchanged — they identify the signer and rebuild the
        signed message)."""
        if self.flag not in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown CommitSig flag {self.flag}")
        if self.is_absent():
            if self.validator_address or self.signature or self.timestamp_ns:
                raise ValueError("absent CommitSig must be empty")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("bad validator address size")
            if aggregate:
                if self.signature:
                    raise ValueError(
                        "CommitSig inside an aggregate commit must not carry "
                        "a per-validator signature"
                    )
            elif not self.signature or len(self.signature) > 96:
                raise ValueError("bad signature size")


def _decode_timestamp(data: bytes) -> int:
    r = pe.Reader(data)
    seconds = nanos = 0
    while not r.eof():
        f, wt = r.read_tag()
        if f == 1:
            seconds = r.read_uvarint()
        elif f == 2:
            nanos = r.read_uvarint()
        else:
            r.skip(wt)
    return seconds * 1_000_000_000 + nanos


@dataclass(frozen=True)
class Commit:
    """+2/3 precommits for a block (reference types/block.go Commit).
    signatures[i] corresponds to validator i of the signing set.

    Aggregate wire variant (the BLS commit path): `agg_sig` holds ONE
    96-byte G2 aggregate of every non-absent precommit signature, and
    the per-validator CommitSigs keep only flag/address/timestamp —
    the flags ARE the signer bitmap (absent vs commit vs nil), the
    timestamps rebuild each signer's distinct sign-bytes. A
    150-validator commit shrinks from ~150 x 96 signature bytes to one,
    at the cost of pairing-heavy verification. Conversion is pure data
    transformation (`aggregate_commit` below): BLS signatures aggregate
    publicly, so the proposer aggregates the very sigs the validators
    gossiped."""

    height: int
    round: int
    block_id: BlockID
    signatures: tuple[CommitSig, ...]
    agg_sig: bytes = b""

    def is_aggregate(self) -> bool:
        return bool(self.agg_sig)

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Rebuild the canonical sign-bytes of validator idx's precommit
        (reference types/block.go:816 → vote.go:93)."""
        cs = self.signatures[idx]
        return vote_sign_bytes(
            chain_id,
            SignedMsgType.PRECOMMIT,
            self.height,
            self.round,
            cs.block_id(self.block_id),
            cs.timestamp_ns,
        )

    def hash(self) -> bytes:
        leaves = [cs.encode() for cs in self.signatures]
        if self.agg_sig:
            # the aggregate is commit content: two commits differing
            # only in agg_sig must hash differently
            leaves.append(self.agg_sig)
        return merkle.hash_from_byte_slices(leaves)

    def size(self) -> int:
        return len(self.signatures)

    def encode(self) -> bytes:
        out = pe.sfixed64_field(1, self.height)
        out += pe.sfixed64_field(2, self.round)
        out += pe.message_field(3, self.block_id.encode())
        for cs in self.signatures:
            out += pe.message_field(4, cs.encode())
        if self.agg_sig:
            out += pe.bytes_field(5, self.agg_sig)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Commit":
        r = pe.Reader(data)
        height = round_ = 0
        block_id = NIL_BLOCK_ID
        sigs: list[CommitSig] = []
        agg_sig = b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                height = r.read_sfixed64()
            elif f == 2:
                round_ = r.read_sfixed64()
            elif f == 3:
                block_id = BlockID.decode(r.read_bytes())
            elif f == 4:
                sigs.append(CommitSig.decode(r.read_bytes()))
                if len(sigs) > MAX_WIRE_COMMIT_SIGS:
                    raise ValueError(
                        f"commit signatures exceed {MAX_WIRE_COMMIT_SIGS}"
                    )
            elif f == 5:
                agg_sig = r.read_bytes()
            else:
                r.skip(wt)
        return cls(height, round_, block_id, tuple(sigs), agg_sig)

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative commit height")
        if self.agg_sig and len(self.agg_sig) != 96:
            raise ValueError("bad aggregate signature size")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            aggregate = self.is_aggregate()
            participating = 0
            for cs in self.signatures:
                cs.validate_basic(aggregate=aggregate)
                if not cs.is_absent():
                    participating += 1
            if aggregate and participating == 0:
                raise ValueError("aggregate commit with no participating signers")


def aggregate_commit(commit: Commit, vals) -> Commit:
    """Convert a fully-signed commit into the aggregate wire variant:
    every non-absent precommit signature (commit AND nil votes — both
    are part of the attested history) folds into one G2 aggregate, and
    the per-validator entries keep flag/address/timestamp only.

    Pure data transformation — BLS signatures aggregate publicly, no
    re-signing. Raises ValueError when any participating signer's key
    is not BLS (mixed-scheme sets keep the per-sig wire form; the
    caller falls back) or when the commit is unsigned. Deterministic:
    the aggregate is a fixed-index-order point sum, so same votes in =>
    byte-identical aggregate commit out (the chaos bit-reproducibility
    surface)."""
    from ..crypto import bls

    if commit.is_aggregate():
        return commit
    sigs: list[bytes] = []
    stripped: list[CommitSig] = []
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            stripped.append(cs)
            continue
        val = vals.get_by_index(idx)
        if val is None or val.pub_key.TYPE != bls.KEY_TYPE:
            raise ValueError(
                f"cannot aggregate commit: validator {idx} is not bls12381"
            )
        sigs.append(cs.signature)
        stripped.append(replace(cs, signature=b""))
    if not sigs:
        raise ValueError("cannot aggregate a commit with no signatures")
    return replace(
        commit,
        signatures=tuple(stripped),
        agg_sig=bls.aggregate_signatures(sigs),
    )


@dataclass(frozen=True)
class Header:
    """Block header (reference types/block.go Header). hash() is the merkle
    root of the deterministic encodings of the 14 fields."""

    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    version: int = 11  # block protocol version (reference version/version.go:27)

    def hash(self) -> bytes:
        """Merkle root over the 14 proto-encoded header fields, byte-exact
        with the reference (types/block.go headerHash region: each field
        runs through cdcEncode — a single-field proto wrapper with
        default-elision — before hashing; Version/Time/LastBlockID are
        their proto messages). Frozen against reference-produced vectors
        in tests/test_light_mbt.py and tests/test_golden_vectors.py."""
        if not self.validators_hash:
            return b""
        cached = self.__dict__.get("_hash")
        if cached is not None:
            return cached

        def cdc(b: bytes) -> bytes:  # gogotypes.BytesValue, empty -> nil
            return pe.bytes_field(1, b)

        fields = [
            pe.varint_field(1, self.version),  # Consensus{block}; app=0 elided
            pe.string_field(1, self.chain_id),
            pe.varint_field(1, self.height),
            encode_timestamp(self.time_ns),
            self.last_block_id.encode(),
            cdc(self.last_commit_hash),
            cdc(self.data_hash),
            cdc(self.validators_hash),
            cdc(self.next_validators_hash),
            cdc(self.consensus_hash),
            cdc(self.app_hash),
            cdc(self.last_results_hash),
            cdc(self.evidence_hash),
            cdc(self.proposer_address),
        ]
        # memoized on the frozen instance: consensus, gossip keying,
        # stores, and light verification all re-ask for the same header
        # hash; the fields can't change, so the root can't either
        root = merkle.hash_from_byte_slices(fields)
        self.__dict__["_hash"] = root
        return root

    def encode(self) -> bytes:
        out = pe.varint_field(1, self.version)
        out += pe.string_field(2, self.chain_id)
        out += pe.varint_field(3, self.height)
        out += pe.message_field(4, encode_timestamp(self.time_ns))
        out += pe.message_field(5, self.last_block_id.encode())
        out += pe.bytes_field(6, self.last_commit_hash)
        out += pe.bytes_field(7, self.data_hash)
        out += pe.bytes_field(8, self.validators_hash)
        out += pe.bytes_field(9, self.next_validators_hash)
        out += pe.bytes_field(10, self.consensus_hash)
        out += pe.bytes_field(11, self.app_hash)
        out += pe.bytes_field(12, self.last_results_hash)
        out += pe.bytes_field(13, self.evidence_hash)
        out += pe.bytes_field(14, self.proposer_address)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        r = pe.Reader(data)
        kw = {}
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["version"] = r.read_uvarint()
            elif f == 2:
                kw["chain_id"] = r.read_bytes().decode()
            elif f == 3:
                kw["height"] = r.read_uvarint()
            elif f == 4:
                kw["time_ns"] = _decode_timestamp(r.read_bytes())
            elif f == 5:
                kw["last_block_id"] = BlockID.decode(r.read_bytes())
            elif f == 6:
                kw["last_commit_hash"] = r.read_bytes()
            elif f == 7:
                kw["data_hash"] = r.read_bytes()
            elif f == 8:
                kw["validators_hash"] = r.read_bytes()
            elif f == 9:
                kw["next_validators_hash"] = r.read_bytes()
            elif f == 10:
                kw["consensus_hash"] = r.read_bytes()
            elif f == 11:
                kw["app_hash"] = r.read_bytes()
            elif f == 12:
                kw["last_results_hash"] = r.read_bytes()
            elif f == 13:
                kw["evidence_hash"] = r.read_bytes()
            elif f == 14:
                kw["proposer_address"] = r.read_bytes()
            else:
                r.skip(wt)
        return cls(**kw)

    def validate_basic(self) -> None:
        if not self.chain_id or len(self.chain_id) > 50:
            raise ValueError("bad chain id")
        if self.height <= 0:
            raise ValueError("non-positive header height")
        if self.proposer_address and len(self.proposer_address) != 20:
            raise ValueError("bad proposer address")


def txs_hash(txs: tuple[bytes, ...]) -> bytes:
    return merkle.hash_from_byte_slices(list(txs))


@dataclass(frozen=True)
class Block:
    header: Header
    txs: tuple[bytes, ...] = ()
    evidence: tuple = ()
    last_commit: Commit | None = None

    def hash(self) -> bytes:
        return self.header.hash()

    def txs_hash(self) -> bytes:
        """Tx merkle root, memoized on the frozen block (the same
        shape as Header.hash()): the proposer computes it building the
        header and every validator recomputes it in validate_basic —
        one tree build per Block instance is enough."""
        cached = self.__dict__.get("_txs_hash")
        if cached is None:
            cached = txs_hash(self.txs)
            self.__dict__["_txs_hash"] = cached
        return cached

    def block_id(self, part_set_header: PartSetHeader) -> BlockID:
        return BlockID(self.hash(), part_set_header)

    def make_part_set(self, part_size: int | None = None):
        """Split into 64KB merkle-proved parts (reference
        types/block.go MakePartSet)."""
        from .part_set import BLOCK_PART_SIZE, PartSet

        return PartSet.from_data(self.encode(), part_size or BLOCK_PART_SIZE)

    def encode(self) -> bytes:
        out = pe.message_field(1, self.header.encode())
        for tx in self.txs:
            out += pe.message_field(2, tx)
        if self.last_commit is not None:
            out += pe.message_field(3, self.last_commit.encode())
        for ev in self.evidence:
            out += pe.message_field(4, ev.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        from .evidence import decode_evidence

        r = pe.Reader(data)
        header = Header()
        txs: list[bytes] = []
        last_commit = None
        evidence: list = []
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                header = Header.decode(r.read_bytes())
            elif f == 2:
                txs.append(r.read_bytes())
                if len(txs) > MAX_WIRE_BLOCK_TXS:
                    raise ValueError(f"block txs exceed {MAX_WIRE_BLOCK_TXS}")
            elif f == 3:
                last_commit = Commit.decode(r.read_bytes())
            elif f == 4:
                evidence.append(decode_evidence(r.read_bytes()))
                if len(evidence) > MAX_WIRE_BLOCK_EVIDENCE:
                    raise ValueError(
                        f"block evidence exceeds {MAX_WIRE_BLOCK_EVIDENCE}"
                    )
            else:
                r.skip(wt)
        return cls(header, tuple(txs), tuple(evidence), last_commit)

    def validate_basic(self) -> None:
        self.header.validate_basic()
        if self.header.height > 1:
            if self.last_commit is None:
                raise ValueError("block above height 1 must carry LastCommit")
            self.last_commit.validate_basic()
            if self.header.last_commit_hash != self.last_commit.hash():
                raise ValueError("last_commit_hash mismatch")
        if self.header.data_hash != self.txs_hash():
            raise ValueError("data_hash mismatch")
