"""Crypto core: key/signature interfaces and the key-type registry.

The port's copy of `tendermint_tpu.crypto` (reference crypto/crypto.go:22-54):
`PubKey`, `PrivKey` and the two-method `BatchVerifier` (`add`, `verify`)
that the commit-verification funnel gates on. The CUDA implementation
registers behind the same interface (crypto/cuda/). Key types: ed25519
and sr25519 (both batch on the card through the Edwards batch
equation), bls12381 (batched and aggregate checks through the pairing
kernels) and secp256k1 (host verification, as in the reference).
"""

from __future__ import annotations

import abc


class PubKey(abc.ABC):
    TYPE: str = ""

    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    def address(self) -> bytes:
        from .hashes import address

        return address(self.bytes())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PubKey)
            and self.TYPE == other.TYPE
            and self.bytes() == other.bytes()
        )

    def __hash__(self) -> int:
        return hash((self.TYPE, self.bytes()))

    def __repr__(self) -> str:
        return f"PubKey{{{self.TYPE}:{self.bytes().hex()[:16]}…}}"


class PrivKey(abc.ABC):
    TYPE: str = ""

    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abc.abstractmethod
    def pub_key(self) -> PubKey: ...


class BatchVerifier(abc.ABC):
    """Accumulate (pubkey, msg, sig) triples, verify them in one shot.

    `verify` returns (all_ok, per_item_validity) — the same contract as the
    reference (crypto/crypto.go:46-54)."""

    @abc.abstractmethod
    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None: ...

    @abc.abstractmethod
    def verify(self) -> tuple[bool, list[bool]]: ...


# registry: key type name -> pubkey decoder
_PUBKEY_DECODERS: dict[str, callable] = {}


def register_pubkey_type(type_name: str, decoder) -> None:
    _PUBKEY_DECODERS[type_name] = decoder


#: builtin key-type modules, lazily imported on first decode
_BUILTIN_KEY_MODULES = {
    "ed25519": "ed25519",
    "secp256k1": "secp256k1",
    "sr25519": "sr25519",
    "bls12381": "bls",
}


def pubkey_from_type_and_bytes(type_name: str, data: bytes) -> PubKey:
    if type_name not in _PUBKEY_DECODERS and type_name in _BUILTIN_KEY_MODULES:
        import importlib

        importlib.import_module(f".{_BUILTIN_KEY_MODULES[type_name]}", __name__)
    try:
        dec = _PUBKEY_DECODERS[type_name]
    except KeyError:
        raise ValueError(f"unknown pubkey type {type_name!r}") from None
    return dec(data)


# The reference's tendermint.crypto.PublicKey proto oneof field numbers
# (proto/tendermint/crypto/keys.proto:13-17).
PUBKEY_PROTO_FIELD = {"ed25519": 1, "secp256k1": 2, "sr25519": 3, "bls12381": 4}
_PUBKEY_PROTO_TYPE = {v: k for k, v in PUBKEY_PROTO_FIELD.items()}


def pubkey_to_proto(pub: PubKey) -> bytes:
    """Serialize as the reference's PublicKey oneof message."""
    from ..libs import protoenc as pe

    return pe.bytes_field(PUBKEY_PROTO_FIELD[pub.TYPE], pub.bytes())


def pubkey_from_proto(data: bytes) -> PubKey:
    from ..libs import protoenc as pe

    r = pe.Reader(data)
    f, _wt = r.read_tag()
    try:
        type_name = _PUBKEY_PROTO_TYPE[f]
    except KeyError:
        raise ValueError(f"unknown PublicKey oneof field {f}") from None
    return pubkey_from_type_and_bytes(type_name, r.read_bytes())
