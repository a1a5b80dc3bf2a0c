"""Evidence of Byzantine behavior (reference types/evidence.go; the port's
copy of tendermint_tpu/types/evidence.py).

DuplicateVoteEvidence: equivocation — two different votes for the same
height/round/type from one validator. LightClientAttackEvidence waits for
the light client's port: decoding one raises."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.hashes import sha256
from ..libs import protoenc as pe
from .validator_set import ValidatorSet
from .vote import Vote

EVIDENCE_DUPLICATE_VOTE = 1
EVIDENCE_LIGHT_CLIENT_ATTACK = 2


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int
    validator_power: int
    timestamp_ns: int

    TYPE = EVIDENCE_DUPLICATE_VOTE

    @classmethod
    def from_votes(
        cls, vote_a: Vote, vote_b: Vote, block_time_ns: int, val_set: ValidatorSet
    ) -> "DuplicateVoteEvidence":
        _, val = val_set.get_by_address(vote_a.validator_address)
        if val is None:
            raise ValueError("evidence from validator not in set")
        # deterministic order: lexicographically smaller block key first
        a, b = vote_a, vote_b
        if a.block_id.key() > b.block_id.key():
            a, b = b, a
        return cls(a, b, val_set.total_voting_power(), val.voting_power, block_time_ns)

    @property
    def height(self) -> int:
        return self.vote_a.height

    def hash(self) -> bytes:
        # memoized: the evidence gossip reactor hashes every pending
        # item per peer per broadcast tick (4 Hz) — recomputing
        # encode+sha256 each time is measurable at committee scale.
        # Safe on a frozen dataclass: the fields can never change.
        h = self.__dict__.get("_hash")
        if h is None:
            h = sha256(self.encode())  # tmtlint: allow[hash-chokepoint] -- memoized single digest (one per evidence lifetime), nothing to batch
            object.__setattr__(self, "_hash", h)
        return h

    def encode(self) -> bytes:
        enc = self.__dict__.get("_enc")
        if enc is None:
            enc = (
                pe.varint_field(1, self.TYPE)
                + pe.message_field(2, self.vote_a.encode())
                + pe.message_field(3, self.vote_b.encode())
                + pe.varint_field(4, self.total_voting_power)
                + pe.varint_field(5, self.validator_power)
                + pe.message_field(6, pe.varint_field(1, self.timestamp_ns))
            )
            object.__setattr__(self, "_enc", enc)
        return enc

    @classmethod
    def decode_fields(cls, r: pe.Reader) -> "DuplicateVoteEvidence":
        va = vb = None
        tvp = vp = ts = 0
        while not r.eof():
            f, wt = r.read_tag()
            if f == 2:
                va = Vote.decode(r.read_bytes())
            elif f == 3:
                vb = Vote.decode(r.read_bytes())
            elif f == 4:
                tvp = r.read_uvarint()
            elif f == 5:
                vp = r.read_uvarint()
            elif f == 6:
                rr = pe.Reader(r.read_bytes())
                while not rr.eof():
                    ff, wwt = rr.read_tag()
                    if ff == 1:
                        ts = rr.read_uvarint()
                    else:
                        rr.skip(wwt)
            else:
                r.skip(wt)
        return cls(va, vb, tvp, vp, ts)

    def validate_basic(self) -> None:
        a, b = self.vote_a, self.vote_b
        if a is None or b is None:
            raise ValueError("missing votes")
        a.validate_basic()
        b.validate_basic()
        if (a.height, a.round, a.type) != (b.height, b.round, b.type):
            raise ValueError("votes are not for the same height/round/type")
        if a.validator_address != b.validator_address:
            raise ValueError("votes from different validators")
        if a.block_id == b.block_id:
            raise ValueError("votes are identical — no equivocation")
        if a.block_id.key() > b.block_id.key():
            raise ValueError("votes not in deterministic order")


def decode_evidence(data: bytes):
    r = pe.Reader(data)
    f, wt = r.read_tag()
    if f != 1 or wt != pe.WIRE_VARINT:
        raise ValueError("evidence missing type tag")
    type_ = r.read_uvarint()
    if type_ == EVIDENCE_DUPLICATE_VOTE:
        return DuplicateVoteEvidence.decode_fields(r)
    if type_ == EVIDENCE_LIGHT_CLIENT_ATTACK:
        raise ValueError("light-client attack evidence waits for the light client port")
    raise ValueError(f"unknown evidence type {type_}")


def evidence_hash(evidence: tuple) -> bytes:
    from ..crypto import merkle

    return merkle.hash_from_byte_slices([ev.encode() for ev in evidence])
