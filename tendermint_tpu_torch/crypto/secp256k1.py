"""secp256k1 ECDSA key types — the port's copy of
tendermint_tpu/crypto/secp256k1.py (reference crypto/secp256k1).

Signatures are 64-byte compact (r||s, 32 bytes each, big-endian) with the
low-S malleability rule enforced on both sign and verify, matching the
reference (crypto/secp256k1/secp256k1_nocgo.go:21-48). Public keys are
33-byte compressed SEC1. Like the reference, secp256k1 has no batch
verifier: commits with such keys verify signature by signature on the
host (BASELINE.md config 4, mixed ed25519 + secp256k1).

Verification and signing use the OpenSSL-backed `cryptography` package
when it is importable and the pure-Python RFC 6979 implementation in
softcrypto.py otherwise — a choice of host library, not a device
fallback. The pure path's nonces are deterministic; OpenSSL's are not, so
only the pure path's signatures are byte-stable."""

from __future__ import annotations

import secrets

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes as crypto_hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        Prehashed,
        decode_dss_signature,
        encode_dss_signature,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    _HAVE_OPENSSL = True
except ImportError:  # degraded path: pure-Python ECDSA (softcrypto)
    _HAVE_OPENSSL = False

from . import PrivKey, PubKey, register_pubkey_type
from . import softcrypto
from .hashes import sha256

KEY_TYPE = "secp256k1"
PUBKEY_SIZE = 33
PRIVKEY_SIZE = 32
SIGNATURE_SIZE = 64

# curve order
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
HALF_N = N // 2


class Secp256k1PubKey(PubKey):
    TYPE = KEY_TYPE

    def __init__(self, data: bytes):
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUBKEY_SIZE} bytes")
        self._bytes = bytes(data)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (0 < r < N and 0 < s <= HALF_N):  # reject high-S (malleability)
            return False
        if not _HAVE_OPENSSL:
            return softcrypto.secp256k1_verify(self._bytes, sha256(msg), r, s)
        try:
            pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256K1(), self._bytes
            )
            pub.verify(
                encode_dss_signature(r, s),
                sha256(msg),
                ec.ECDSA(Prehashed(crypto_hashes.SHA256())),
            )
            return True
        except (InvalidSignature, ValueError):
            return False


class Secp256k1PrivKey(PrivKey):
    TYPE = KEY_TYPE

    def __init__(self, data: bytes):
        if len(data) != PRIVKEY_SIZE:
            raise ValueError(f"secp256k1 privkey must be {PRIVKEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._d = int.from_bytes(data, "big")
        if _HAVE_OPENSSL:
            self._sk = ec.derive_private_key(self._d, ec.SECP256K1())
            self._pub = self._sk.public_key().public_bytes(
                Encoding.X962, PublicFormat.CompressedPoint
            )
        else:
            self._sk = None
            self._pub = softcrypto.secp256k1_pub(self._d)

    @classmethod
    def generate(cls) -> "Secp256k1PrivKey":
        while True:
            d = secrets.token_bytes(PRIVKEY_SIZE)
            v = int.from_bytes(d, "big")
            if 0 < v < N:
                return cls(d)

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        if self._sk is not None:
            der = self._sk.sign(
                sha256(msg), ec.ECDSA(Prehashed(crypto_hashes.SHA256()))
            )
            r, s = decode_dss_signature(der)
        else:
            r, s = softcrypto.secp256k1_sign(self._d, sha256(msg))
        if s > HALF_N:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> Secp256k1PubKey:
        return Secp256k1PubKey(self._pub)


register_pubkey_type(KEY_TYPE, Secp256k1PubKey)
