"""Ed25519 key types (analog of reference crypto/ed25519/ed25519.go).

Signing and the fast-path verification use the OpenSSL-backed `cryptography`
package when it is importable; consensus-facing verification follows ZIP-215
semantics (reference crypto/ed25519/ed25519.go:26-28): OpenSSL's
(cofactorless, canonical-only) accept set is a strict subset of ZIP-215's, so
an OpenSSL accept is final and an OpenSSL reject falls back to the pure-Python
cofactored verifier in ed25519_math.py.

Without `cryptography` the module uses the pure-Python RFC 8032
implementation in ed25519_math.py for both signing and verification (same
deterministic signatures, same ZIP-215 accept set). Batch verification is
dispatched through crypto/batch.py and runs on the card (crypto/cuda/)."""

from __future__ import annotations

import secrets

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    _HAVE_OPENSSL = True
except ImportError:  # pure-Python RFC 8032 path (ed25519_math)
    _HAVE_OPENSSL = False

from . import PrivKey, PubKey, register_pubkey_type
from . import ed25519_math

KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 32  # seed
SIGNATURE_SIZE = 64


class Ed25519PubKey(PubKey):
    TYPE = KEY_TYPE

    def __init__(self, data: bytes):
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes")
        self._bytes = bytes(data)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        if _HAVE_OPENSSL:
            try:
                Ed25519PublicKey.from_public_bytes(self._bytes).verify(sig, msg)
                return True
            except (InvalidSignature, ValueError):
                # OpenSSL rejects some ZIP-215-valid signatures (non-canonical
                # R/A encodings, mixed-order points); re-check cofactored.
                pass
        return ed25519_math.verify_zip215(self._bytes, msg, sig)


class Ed25519PrivKey(PrivKey):
    TYPE = KEY_TYPE

    def __init__(self, seed: bytes):
        if len(seed) != PRIVKEY_SIZE:
            raise ValueError(f"ed25519 privkey seed must be {PRIVKEY_SIZE} bytes")
        self._seed = bytes(seed)
        if _HAVE_OPENSSL:
            self._sk = Ed25519PrivateKey.from_private_bytes(self._seed)
            self._pub = self._sk.public_key().public_bytes(
                Encoding.Raw, PublicFormat.Raw
            )
        else:
            self._sk = None
            self._pub = ed25519_math.public_from_seed(self._seed)

    @classmethod
    def generate(cls) -> "Ed25519PrivKey":
        return cls(secrets.token_bytes(PRIVKEY_SIZE))

    def bytes(self) -> bytes:
        return self._seed

    def sign(self, msg: bytes) -> bytes:
        if self._sk is not None:
            return self._sk.sign(msg)
        return ed25519_math.sign(self._seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._pub)


register_pubkey_type(KEY_TYPE, Ed25519PubKey)
