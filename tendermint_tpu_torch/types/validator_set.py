"""Validator and ValidatorSet with proposer-priority rotation (the port's
copy of tendermint_tpu/types/validator_set.py).

Behavioral analog of reference types/validator_set.go (933 LoC): weighted
round-robin proposer selection via accumulating priorities, rescaling to a
2·totalPower window, centering around zero, and the -1.125·totalPower
penalty for newly joining validators. Integer division follows truncation
toward zero (the reference's Go semantics) — Python's floor division would
diverge on negative priorities, so `_div_trunc` is used throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..crypto import PubKey
from ..crypto.merkle import hash_from_byte_slices
from ..libs import protoenc as pe
from .keys import MAX_TOTAL_VOTING_POWER, PRIORITY_WINDOW_SIZE_FACTOR

# Wire-side sanity bound: validator sets ride untrusted frames (light
# blocks, statesync params, evidence) — a corrupt repeat count must
# raise at decode, never allocate (tmtlint wire-bounds). Real
# committees are ≤ a few hundred validators.
MAX_WIRE_VALIDATORS = 1 << 16


def _div_trunc(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return q


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power, self.proposer_priority)

    def simple_encode(self) -> bytes:
        """SimpleValidator proto encoding used for the validator-set hash
        (reference types/validator.go Bytes(): SimpleValidator{PubKey,
        VotingPower}) — byte-exact with the reference; frozen against its
        MBT vectors in tests/test_light_mbt.py."""
        from ..crypto import pubkey_to_proto

        out = pe.message_field(1, pubkey_to_proto(self.pub_key))
        out += pe.varint_field(2, self.voting_power)
        return out

    def encode(self) -> bytes:
        out = self.simple_encode()
        out += pe.sfixed64_field(3, self.proposer_priority)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Validator":
        from .. import crypto

        r = pe.Reader(data)
        pub, power, prio = None, 0, 0
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                pub = crypto.pubkey_from_proto(r.read_bytes())
            elif f == 2:
                power = r.read_uvarint()
            elif f == 3:
                prio = r.read_sfixed64()
            else:
                r.skip(wt)
        if pub is None:
            # fail HERE so the router's decode guard converts it into a
            # peer error, instead of a None pub key detonating later
            # inside reactor logic
            raise ValueError("validator encoding missing public key")
        return cls(pub, power, prio)


class ValidatorSet:
    """Ordered validator set. Order: voting power descending, then address
    ascending — fixed at construction and preserved across priority updates
    (the hash depends on it)."""

    def __init__(self, validators: list[Validator]):
        vals = [v.copy() for v in validators]
        vals.sort(key=lambda v: (-v.voting_power, v.address))
        self.validators = vals
        self._proposer: Validator | None = None
        self._hash: bytes | None = None  # memo; priorities don't affect it
        if self.total_voting_power() > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power exceeds maximum")
        if vals:
            self.increment_proposer_priority(1)

    # -- lookups ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.validators)

    def get_by_index(self, idx: int) -> Validator | None:
        if 0 <= idx < len(self.validators):
            return self.validators[idx]
        return None

    def get_by_address(self, addr: bytes) -> tuple[int, Validator | None]:
        for i, v in enumerate(self.validators):
            if v.address == addr:
                return i, v
        return -1, None

    def has_address(self, addr: bytes) -> bool:
        return self.get_by_address(addr)[1] is not None

    def total_voting_power(self) -> int:
        return sum(v.voting_power for v in self.validators)

    # -- proposer rotation ----------------------------------------------

    def get_proposer(self) -> Validator:
        if self._proposer is None:
            self._proposer = self._find_proposer()
        return self._proposer

    def _find_proposer(self) -> Validator:
        best = self.validators[0]
        for v in self.validators[1:]:
            if v.proposer_priority > best.proposer_priority or (
                v.proposer_priority == best.proposer_priority and v.address < best.address
            ):
                best = v
        return best

    def rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0 or not self.validators:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                v.proposer_priority = _div_trunc(v.proposer_priority, ratio)

    def _shift_by_avg_proposer_priority(self) -> None:
        n = len(self.validators)
        avg = _div_trunc(sum(v.proposer_priority for v in self.validators), n)
        for v in self.validators:
            v.proposer_priority -= avg

    def increment_proposer_priority(self, times: int) -> None:
        """Advance the weighted round-robin `times` steps (reference
        types/validator_set.go:77-109)."""
        if not self.validators:
            return
        total = self.total_voting_power()
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * total)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            for v in self.validators:
                v.proposer_priority += v.voting_power
            proposer = self._find_proposer()
            proposer.proposer_priority -= total
        self._proposer = proposer

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    def copy(self) -> "ValidatorSet":
        new = object.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new._proposer = None
        new._hash = self._hash  # same keys/powers -> same hash
        if self._proposer is not None:
            idx, _ = new.get_by_address(self._proposer.address)
            new._proposer = new.validators[idx] if idx >= 0 else None
        return new

    # -- updates ---------------------------------------------------------

    def update_with_change_set(self, changes: list[Validator]) -> None:
        """Apply validator updates from the application: power 0 removes,
        otherwise add/update. New validators join with priority
        -(totalPower + totalPower/8), keeping them from proposing
        immediately (reference types/validator_set.go update path)."""
        by_addr = {v.address: v for v in self.validators}
        seen: set[bytes] = set()
        for c in changes:
            addr = c.address
            if addr in seen:
                raise ValueError("duplicate address in change set")
            seen.add(addr)
            if c.voting_power < 0:
                raise ValueError("negative voting power")
            if c.voting_power == 0:
                if addr not in by_addr:
                    raise ValueError("removing unknown validator")
                del by_addr[addr]
            elif addr in by_addr:
                by_addr[addr].voting_power = c.voting_power
            else:
                by_addr[addr] = Validator(c.pub_key, c.voting_power)
        if not by_addr:
            raise ValueError("validator set cannot become empty")
        new_vals = list(by_addr.values())
        total = sum(v.voting_power for v in new_vals)
        if total > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power exceeds maximum")
        penalty = -(total + _div_trunc(total, 8))
        existing = {v.address for v in self.validators}
        for v in new_vals:
            if v.address not in existing:
                v.proposer_priority = penalty
        new_vals.sort(key=lambda v: (-v.voting_power, v.address))
        self.validators = new_vals
        self._proposer = None
        self._hash = None
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * total)
        self._shift_by_avg_proposer_priority()

    # -- hashing / serialization ----------------------------------------

    def hash(self) -> bytes:
        """Merkle root of the simple-encoded validators (reference
        types/validator_set.go:77-109 region). Memoized: the hash covers
        pubkeys + powers only, which change solely through
        update_with_change_set (proposer-priority churn doesn't touch it),
        and hot paths (block-sync rotation guards) call this per block."""
        if self._hash is None:
            self._hash = hash_from_byte_slices(
                [v.simple_encode() for v in self.validators]
            )
        return self._hash

    def encode(self) -> bytes:
        out = b""
        for v in self.validators:
            out += pe.message_field(1, v.encode())
        if self._proposer is not None:
            out += pe.bytes_field(2, self._proposer.address)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorSet":
        r = pe.Reader(data)
        vals: list[Validator] = []
        proposer_addr = b""
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                vals.append(Validator.decode(r.read_bytes()))
                if len(vals) > MAX_WIRE_VALIDATORS:
                    raise ValueError(
                        f"validator set exceeds {MAX_WIRE_VALIDATORS} entries"
                    )
            elif f == 2:
                proposer_addr = r.read_bytes()
            else:
                r.skip(wt)
        new = object.__new__(cls)
        new.validators = vals
        new._proposer = None
        new._hash = None
        if proposer_addr:
            idx, v = new.get_by_address(proposer_addr)
            new._proposer = v
        return new

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        seen = set()
        for v in self.validators:
            if v.voting_power <= 0:
                raise ValueError("validator with non-positive power")
            if v.address in seen:
                raise ValueError("duplicate validator address")
            seen.add(v.address)
