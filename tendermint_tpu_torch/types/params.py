"""Consensus parameters (reference types/params.go): per-chain limits the
application can tune via EndBlock updates, hashed into each header's
consensus_hash."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..crypto.hashes import sha256
from ..libs import protoenc as pe

# Wire-side sanity bound: params ride untrusted statesync frames — a
# corrupt repeat count must raise, never allocate (tmtlint wire-bounds).
# The key-type registry has single digits of schemes.
MAX_PUB_KEY_TYPES = 64


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 22_020_096  # 21 MB
    max_gas: int = -1


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100_000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1_048_576


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple[str, ...] = ("ed25519",)


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)

    def hash(self) -> bytes:
        return sha256(self.encode())  # tmtlint: allow[hash-chokepoint] -- one cold digest per params update, nothing to batch or account

    def encode(self) -> bytes:
        b = pe.varint_field(1, self.block.max_bytes) + pe.sfixed64_field(
            2, self.block.max_gas
        )
        e = (
            pe.varint_field(1, self.evidence.max_age_num_blocks)
            + pe.varint_field(2, self.evidence.max_age_duration_ns)
            + pe.varint_field(3, self.evidence.max_bytes)
        )
        v = b"".join(pe.string_field(1, t) for t in self.validator.pub_key_types)
        return (
            pe.message_field(1, b) + pe.message_field(2, e) + pe.message_field(3, v)
        )

    @classmethod
    def decode(cls, data: bytes) -> "ConsensusParams":
        r = pe.Reader(data)
        block, ev, val = BlockParams(), EvidenceParams(), ValidatorParams()
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                rr = pe.Reader(r.read_bytes())
                mb, mg = 0, 0
                while not rr.eof():
                    ff, wwt = rr.read_tag()
                    if ff == 1:
                        mb = rr.read_uvarint()
                    elif ff == 2:
                        mg = rr.read_sfixed64()
                    else:
                        rr.skip(wwt)
                block = BlockParams(mb, mg)
            elif f == 2:
                rr = pe.Reader(r.read_bytes())
                ab, ad, mb = 0, 0, 0
                while not rr.eof():
                    ff, wwt = rr.read_tag()
                    if ff == 1:
                        ab = rr.read_uvarint()
                    elif ff == 2:
                        ad = rr.read_uvarint()
                    elif ff == 3:
                        mb = rr.read_uvarint()
                    else:
                        rr.skip(wwt)
                ev = EvidenceParams(ab, ad, mb)
            elif f == 3:
                rr = pe.Reader(r.read_bytes())
                types = []
                while not rr.eof():
                    ff, wwt = rr.read_tag()
                    if ff == 1:
                        types.append(rr.read_bytes().decode())
                        if len(types) > MAX_PUB_KEY_TYPES:
                            raise ValueError(
                                f"pub_key_types exceed {MAX_PUB_KEY_TYPES}"
                            )
                    else:
                        rr.skip(wwt)
                val = ValidatorParams(tuple(types))
            else:
                r.skip(wt)
        return cls(block, ev, val)

    def validate_basic(self) -> None:
        if self.block.max_bytes <= 0:
            raise ValueError("block.max_bytes must be positive")
        if self.block.max_gas < -1:
            raise ValueError("block.max_gas must be >= -1")
        if not self.validator.pub_key_types:
            raise ValueError("no allowed pubkey types")

    def update(self, **kwargs) -> "ConsensusParams":
        return replace(self, **kwargs)
