"""Vote — a prevote or precommit from a single validator (reference
types/vote.go; the port's copy of tendermint_tpu/types/vote.py), and the
block Proposal, which shares the canonical sign-bytes machinery."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protoenc as pe
from .block import BlockID, NIL_BLOCK_ID, _decode_timestamp
from .canonical import encode_timestamp, proposal_sign_bytes, vote_sign_bytes
from .keys import SignedMsgType


@dataclass(frozen=True)
class Vote:
    type: SignedMsgType
    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return vote_sign_bytes(
            chain_id, self.type, self.height, self.round, self.block_id, self.timestamp_ns
        )

    def verify(self, chain_id: str, pub_key) -> bool:
        """Single-vote verification (reference types/vote.go:147),
        through the VerifyHub's sync facade when one is running."""
        if pub_key.address() != self.validator_address:
            return False
        from ..crypto.verify_hub import verify_one

        return verify_one(pub_key, self.sign_bytes(chain_id), self.signature)

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def encode(self) -> bytes:
        out = pe.varint_field(1, int(self.type))
        out += pe.sfixed64_field(2, self.height)
        out += pe.sfixed64_field(3, self.round)
        out += pe.message_field(4, self.block_id.encode())
        out += pe.message_field(5, encode_timestamp(self.timestamp_ns))
        out += pe.bytes_field(6, self.validator_address)
        out += pe.varint_field(7, self.validator_index + 1)  # +1: index 0 must round-trip
        out += pe.bytes_field(8, self.signature)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        r = pe.Reader(data)
        kw = dict(
            type=SignedMsgType.UNKNOWN,
            height=0,
            round=0,
            block_id=NIL_BLOCK_ID,
            timestamp_ns=0,
            validator_address=b"",
            validator_index=-1,
            signature=b"",
        )
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["type"] = SignedMsgType(r.read_uvarint())
            elif f == 2:
                kw["height"] = r.read_sfixed64()
            elif f == 3:
                kw["round"] = r.read_sfixed64()
            elif f == 4:
                kw["block_id"] = BlockID.decode(r.read_bytes())
            elif f == 5:
                kw["timestamp_ns"] = _decode_timestamp(r.read_bytes())
            elif f == 6:
                kw["validator_address"] = r.read_bytes()
            elif f == 7:
                kw["validator_index"] = r.read_uvarint() - 1
            elif f == 8:
                kw["signature"] = r.read_bytes()
            else:
                r.skip(wt)
        return cls(**kw)

    def validate_basic(self) -> None:
        if self.type not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise ValueError("invalid vote type")
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        self.block_id.validate_basic()
        if len(self.validator_address) != 20:
            raise ValueError("bad validator address")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature or len(self.signature) > 96:
            raise ValueError("bad signature")


@dataclass(frozen=True)
class Proposal:
    """Block proposal for (height, round) (reference types/proposal.go).
    pol_round is the proof-of-lock round, -1 when unlocked."""

    height: int
    round: int
    pol_round: int
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round, self.block_id, self.timestamp_ns
        )

    def encode(self) -> bytes:
        out = pe.sfixed64_field(1, self.height)
        out += pe.sfixed64_field(2, self.round)
        out += pe.sfixed64_field(3, self.pol_round if self.pol_round >= 0 else -1)
        out += pe.message_field(4, self.block_id.encode())
        out += pe.message_field(5, encode_timestamp(self.timestamp_ns))
        out += pe.bytes_field(6, self.signature)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        r = pe.Reader(data)
        kw = dict(height=0, round=0, pol_round=-1, block_id=NIL_BLOCK_ID, timestamp_ns=0, signature=b"")
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                kw["height"] = r.read_sfixed64()
            elif f == 2:
                kw["round"] = r.read_sfixed64()
            elif f == 3:
                kw["pol_round"] = r.read_sfixed64()
            elif f == 4:
                kw["block_id"] = BlockID.decode(r.read_bytes())
            elif f == 5:
                kw["timestamp_ns"] = _decode_timestamp(r.read_bytes())
            elif f == 6:
                kw["signature"] = r.read_bytes()
            else:
                r.skip(wt)
        return cls(**kw)

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError("invalid pol_round")
        if not self.block_id.is_complete():
            raise ValueError("proposal must carry a complete block id")
        if not self.signature or len(self.signature) > 96:
            raise ValueError("bad signature")
