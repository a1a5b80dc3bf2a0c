"""Light-client types (reference types/light.go; the port's copy of
tendermint_tpu/light/types.py): SignedHeader = header + the commit that
signed it; LightBlock adds the validator set."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protoenc as pe
from ..types.block import Commit, Header
from ..types.validator_set import ValidatorSet


@dataclass(frozen=True)
class SignedHeader:
    header: Header
    commit: Commit

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None or self.commit is None:
            raise ValueError("signed header missing header or commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header chain id {self.header.chain_id!r} != {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError("commit height != header height")
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit signs a different header")

    @property
    def height(self) -> int:
        return self.header.height

    def encode(self) -> bytes:
        return pe.message_field(1, self.header.encode()) + pe.message_field(
            2, self.commit.encode()
        )

    @classmethod
    def decode(cls, data: bytes) -> "SignedHeader":
        r = pe.Reader(data)
        header = commit = None
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                header = Header.decode(r.read_bytes())
            elif f == 2:
                commit = Commit.decode(r.read_bytes())
            else:
                r.skip(wt)
        return cls(header, commit)


@dataclass(frozen=True)
class LightBlock:
    signed_header: SignedHeader
    validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def header(self) -> Header:
        return self.signed_header.header

    def validate_basic(self, chain_id: str) -> None:
        if self.validators is None:
            raise ValueError("light block missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validators.validate_basic()
        if self.header.validators_hash != self.validators.hash():
            raise ValueError("validators hash does not match header")

    def encode(self) -> bytes:
        return pe.message_field(1, self.signed_header.encode()) + pe.message_field(
            2, self.validators.encode()
        )

    @classmethod
    def decode(cls, data: bytes) -> "LightBlock":
        r = pe.Reader(data)
        sh = vals = None
        while not r.eof():
            f, wt = r.read_tag()
            if f == 1:
                sh = SignedHeader.decode(r.read_bytes())
            elif f == 2:
                vals = ValidatorSet.decode(r.read_bytes())
            else:
                r.skip(wt)
        return cls(sh, vals)
