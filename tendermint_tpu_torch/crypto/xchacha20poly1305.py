"""XChaCha20-Poly1305 AEAD (reference crypto/xchacha20poly1305/
xchachapoly.go:1 — draft-irtf-cfrg-xchacha semantics).

Extends the 12-byte-nonce ChaCha20-Poly1305 (which the P2P secret
connection already uses, p2p/secret.py) to 24-byte random-safe nonces:

    subkey = HChaCha20(key, nonce[:16])
    ciphertext = ChaCha20-Poly1305(subkey, b"\\x00"*4 + nonce[16:], ...)

HChaCha20 is implemented here directly (the 20-round ChaCha core without
the final feed-forward, returning words 0-3 and 12-15); the inner AEAD
rides the same OpenSSL-backed primitive as the rest of the stack. The
port's copy of tendermint_tpu/crypto/xchacha20poly1305.py.
"""

from __future__ import annotations

import struct

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # degraded path: pure-Python RFC 8439 (softcrypto)
    from .softcrypto import ChaCha20Poly1305, InvalidTag

__all__ = ["XChaCha20Poly1305", "hchacha20", "InvalidTag"]

KEY_SIZE = 32
NONCE_SIZE = 24
TAG_SIZE = 16

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & 0xFFFFFFFF


def _quarter(s: list[int], a: int, b: int, c: int, d: int) -> None:
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl32(s[b] ^ s[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """RFC draft HChaCha20: 32-byte subkey from key + 16-byte nonce."""
    if len(key) != KEY_SIZE:
        raise ValueError("hchacha20: key must be 32 bytes")
    if len(nonce16) != 16:
        raise ValueError("hchacha20: nonce must be 16 bytes")
    s = list(_SIGMA) + list(struct.unpack("<8L", key)) + list(
        struct.unpack("<4L", nonce16)
    )
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return struct.pack("<8L", *(s[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


class XChaCha20Poly1305:
    """AEAD with 24-byte nonces (reference xchachapoly.go:16 New)."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError("xchacha20poly1305: bad key length")
        self._key = bytes(key)

    def _inner(self, nonce: bytes) -> tuple[ChaCha20Poly1305, bytes]:
        if len(nonce) != NONCE_SIZE:
            raise ValueError("xchacha20poly1305: bad nonce length")
        subkey = hchacha20(self._key, nonce[:16])
        return ChaCha20Poly1305(subkey), b"\x00" * 4 + nonce[16:]

    def seal(self, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.encrypt(n12, plaintext, aad or None)

    def open(self, nonce: bytes, ciphertext: bytes, aad: bytes = b"") -> bytes:
        """Raises InvalidTag (re-exported from this module) on forgery."""
        aead, n12 = self._inner(nonce)
        return aead.decrypt(n12, ciphertext, aad or None)
