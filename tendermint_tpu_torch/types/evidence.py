"""Evidence of Byzantine behavior (reference types/evidence.go; the port's
copy of tendermint_tpu/types/evidence.py).

DuplicateVoteEvidence: equivocation — two different votes for the same
height/round/type from one validator.

LightClientAttackEvidence (reference types/evidence.go:214): a provider
served a light client a conflicting, properly-signed header. The evidence
carries the whole conflicting light block, the last height at which the
attacked client and the attacker agreed (common height), and the
validators the attack can be attributed to."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.hashes import sha256
from ..libs import protoenc as pe
from .validator_set import MAX_WIRE_VALIDATORS, Validator, ValidatorSet
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


@dataclass(frozen=True)
class LightClientAttackEvidence:
    """Reference types/evidence.go:214. `conflicting_block` is the forged
    (but properly signed) light block; `common_height` the last height the
    divergent chains agreed at; `byzantine_validators` the validators the
    attack is attributable to (empty for amnesia attacks)."""

    conflicting_block: object  # light.types.LightBlock (lazy to avoid cycle)
    common_height: int
    byzantine_validators: tuple  # tuple[Validator, ...]
    total_voting_power: int
    timestamp_ns: int

    TYPE = EVIDENCE_LIGHT_CLIENT_ATTACK

    @property
    def height(self) -> int:
        # expiry is measured from the common height (evidence.go Height())
        return self.common_height

    @property
    def conflicting_height(self) -> int:
        return self.conflicting_block.height

    def hash(self) -> bytes:
        # header hash + common height: the same attack reported with
        # different byzantine attributions dedupes to one entry.
        # Memoized (the DuplicateVoteEvidence pattern): the gossip
        # reactor hashes every pending item per peer per 4 Hz tick, and
        # an LCA hash covers a whole committee-scale header — safe on a
        # frozen dataclass.
        h = self.__dict__.get("_hash")
        if h is None:
            # tmtlint: allow[hash-chokepoint] -- memoized single digest over two small fields, nothing to batch
            h = sha256(
                self.conflicting_block.header.hash()
                + self.common_height.to_bytes(8, "big")
            )
            object.__setattr__(self, "_hash", h)
        return h

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Lunatic attack: the conflicting header fabricates one of the
        fields that are deterministically derived from state (reference
        evidence.go ConflictingHeaderIsInvalid)."""
        h, t = self.conflicting_block.header, trusted_header
        return not (
            h.validators_hash == t.validators_hash
            and h.next_validators_hash == t.next_validators_hash
            and h.consensus_hash == t.consensus_hash
            and h.app_hash == t.app_hash
            and h.last_results_hash == t.last_results_hash
        )

    def get_byzantine_validators(
        self, common_vals: ValidatorSet, trusted_signed_header
    ) -> list[Validator]:
        """Who to punish (reference evidence.go GetByzantineValidators):
        lunatic → common-set validators who signed the conflicting block;
        equivocation (same round) → validators who signed both blocks;
        amnesia (different rounds) → unattributable, empty."""
        conflicting_commit = self.conflicting_block.signed_header.commit
        out: list[Validator] = []
        if self.conflicting_header_is_invalid(trusted_signed_header.header):
            for sig in conflicting_commit.signatures:
                if not sig.is_commit():
                    continue
                _, val = common_vals.get_by_address(sig.validator_address)
                if val is not None:
                    out.append(val)
        elif trusted_signed_header.commit.round == conflicting_commit.round:
            trusted_signers = {
                s.validator_address
                for s in trusted_signed_header.commit.signatures
                if s.is_commit()
            }
            for sig in conflicting_commit.signatures:
                if not sig.is_commit() or sig.validator_address not in trusted_signers:
                    continue
                _, val = self.conflicting_block.validators.get_by_address(
                    sig.validator_address
                )
                if val is not None:
                    out.append(val)
        out.sort(key=lambda v: (-v.voting_power, v.address))
        return out

    def encode(self) -> bytes:
        # memoized like hash(): an LCA encoding carries the entire
        # conflicting light block (validator set + commit), re-encoded
        # otherwise on every broadcast poll and pool size pass
        enc = self.__dict__.get("_enc")
        if enc is None:
            enc = pe.varint_field(1, self.TYPE)
            enc += pe.message_field(2, self.conflicting_block.encode())
            enc += pe.varint_field(3, self.common_height)
            for val in self.byzantine_validators:
                enc += pe.message_field(4, val.encode())
            enc += pe.varint_field(5, self.total_voting_power)
            enc += pe.message_field(6, pe.varint_field(1, self.timestamp_ns))
            object.__setattr__(self, "_enc", enc)
        return enc

    @classmethod
    def decode_fields(cls, r: pe.Reader) -> "LightClientAttackEvidence":
        from ..light.types import LightBlock

        cb = None
        ch = tvp = ts = 0
        byz: list[Validator] = []
        while not r.eof():
            f, wt = r.read_tag()
            if f == 2:
                cb = LightBlock.decode(r.read_bytes())
            elif f == 3:
                ch = r.read_uvarint()
            elif f == 4:
                byz.append(Validator.decode(r.read_bytes()))
                if len(byz) > MAX_WIRE_VALIDATORS:
                    raise ValueError(
                        f"LCA byzantine validators exceed {MAX_WIRE_VALIDATORS}"
                    )
            elif f == 5:
                tvp = r.read_uvarint()
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
        return cls(cb, ch, tuple(byz), tvp, ts)

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("missing conflicting block")
        if self.conflicting_block.signed_header is None:
            raise ValueError("conflicting block missing signed header")
        if self.conflicting_block.validators is None:
            raise ValueError("conflicting block missing validator set")
        if self.common_height <= 0:
            raise ValueError("non-positive common height")
        if self.common_height > self.conflicting_block.height:
            raise ValueError("common height beyond conflicting block height")
        if self.total_voting_power <= 0:
            raise ValueError("non-positive total voting power")


def decode_evidence(data: bytes):
    r = pe.Reader(data)
    f, wt = r.read_tag()
    if f != 1 or wt != pe.WIRE_VARINT:
        raise ValueError("evidence missing type tag")
    type_ = r.read_uvarint()
    if type_ == EVIDENCE_DUPLICATE_VOTE:
        return DuplicateVoteEvidence.decode_fields(r)
    if type_ == EVIDENCE_LIGHT_CLIENT_ATTACK:
        return LightClientAttackEvidence.decode_fields(r)
    raise ValueError(f"unknown evidence type {type_}")


def evidence_hash(evidence: tuple) -> bytes:
    from ..crypto import merkle

    return merkle.hash_from_byte_slices([ev.encode() for ev in evidence])
