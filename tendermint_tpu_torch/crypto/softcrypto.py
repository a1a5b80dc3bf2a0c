"""Pure-Python primitives used when the OpenSSL-backed `cryptography`
package is absent (graceful degradation: the node must come up — slower —
on a bare accelerator image rather than fail to import).

Every construction here is the textbook/RFC formulation and is exercised
against the same test vectors as the OpenSSL path:

  * ChaCha20-Poly1305 AEAD (RFC 8439) — the ChaCha20 rounds are
    numpy-vectorized over all counter blocks of a message at once, so a
    1 KB secret-connection frame costs ~320 array ops, not 320 per block;
    Poly1305 runs on Python bigints (one mulmod per 16-byte chunk).
  * X25519 (RFC 7748) — constant-structure Montgomery ladder (python ints
    are not constant-time; acceptable for the degraded path, which is
    meant for tests/CI images, not hostile production deployments).
  * HKDF-SHA256 (RFC 5869) over stdlib hmac.
  * secp256k1 ECDSA with RFC 6979 deterministic nonces, Jacobian
    coordinates, low-S normalization by the caller.

Modules that prefer OpenSSL do `try: import cryptography ... except
ImportError: from . import softcrypto` and keep an identical call shape.
The port's copy of tendermint_tpu/crypto/softcrypto.py, whole.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets
import struct

import numpy as np


class InvalidTag(Exception):
    """AEAD authentication failure (mirrors cryptography.exceptions.InvalidTag)."""


# ---------------------------------------------------------------------------
# ChaCha20 (RFC 8439 §2.3) — vectorized over counter blocks
# ---------------------------------------------------------------------------

_SIGMA = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _rotl(x: np.ndarray, c: int) -> np.ndarray:
    return (x << np.uint32(c)) | (x >> np.uint32(32 - c))


def _quarter(s: list, a: int, b: int, c: int, d: int) -> None:
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha20_keystream(key: bytes, counter: int, nonce12: bytes, length: int) -> bytes:
    """Keystream bytes for (key, nonce) starting at block `counter`. All
    blocks are computed in one vectorized pass: state is (16, n_blocks)
    uint32 with only row 12 (the counter) varying."""
    if len(key) != 32 or len(nonce12) != 12:
        raise ValueError("chacha20: bad key/nonce length")
    n_blocks = (length + 63) // 64
    if n_blocks == 0:
        return b""
    init = np.empty((16, n_blocks), dtype=np.uint32)
    init[0:4] = _SIGMA[:, None]
    init[4:12] = np.frombuffer(key, dtype="<u4").astype(np.uint32)[:, None]
    init[12] = (counter + np.arange(n_blocks, dtype=np.uint64)).astype(np.uint32)
    init[13:16] = np.frombuffer(nonce12, dtype="<u4").astype(np.uint32)[:, None]
    s = [init[i].copy() for i in range(16)]
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    out = np.empty((16, n_blocks), dtype=np.uint32)
    for i in range(16):
        out[i] = s[i] + init[i]
    # serialize: blocks are columns; words little-endian within a block
    stream = out.T.astype("<u4").tobytes()
    return stream[:length]


def chacha20_xor(key: bytes, counter: int, nonce12: bytes, data: bytes) -> bytes:
    ks = chacha20_keystream(key, counter, nonce12, len(data))
    return (
        np.frombuffer(data, dtype=np.uint8)
        ^ np.frombuffer(ks, dtype=np.uint8)
    ).tobytes()


# ---------------------------------------------------------------------------
# Poly1305 (RFC 8439 §2.5)
# ---------------------------------------------------------------------------

_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305_mac(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & _CLAMP
    s = int.from_bytes(key32[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i : i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = (acc + n) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"" if rem == 0 else b"\x00" * (16 - rem)


class ChaCha20Poly1305:
    """RFC 8439 AEAD; API-compatible subset of
    cryptography.hazmat.primitives.ciphers.aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("chacha20poly1305: key must be 32 bytes")
        self._key = bytes(key)

    def _mac(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        otk = chacha20_keystream(self._key, 0, nonce, 32)
        mac_data = (
            aad
            + _pad16(aad)
            + ct
            + _pad16(ct)
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return poly1305_mac(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = aad or b""
        ct = chacha20_xor(self._key, 1, nonce, data)
        return ct + self._mac(nonce, aad, ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than tag")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        if not _hmac.compare_digest(self._mac(nonce, aad, ct), tag):
            raise InvalidTag("poly1305 tag mismatch")
        return chacha20_xor(self._key, 1, nonce, ct)


# ---------------------------------------------------------------------------
# X25519 (RFC 7748 §5)
# ---------------------------------------------------------------------------

_P255 = 2**255 - 19
_A24 = 121665


def _x25519_scalarmult(k_int: int, u_int: int) -> int:
    x1 = u_int % _P255
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (k_int >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        A = (x2 + z2) % _P255
        AA = A * A % _P255
        B = (x2 - z2) % _P255
        BB = B * B % _P255
        E = (AA - BB) % _P255
        C = (x3 + z3) % _P255
        D = (x3 - z3) % _P255
        DA = D * A % _P255
        CB = C * B % _P255
        x3 = (DA + CB) % _P255
        x3 = x3 * x3 % _P255
        z3 = (DA - CB) % _P255
        z3 = z3 * z3 % _P255 * x1 % _P255
        x2 = AA * BB % _P255
        z2 = E * (AA + _A24 * E) % _P255
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P255 - 2, _P255) % _P255


def x25519(private32: bytes, public32: bytes) -> bytes:
    """Scalar multiplication with RFC 7748 clamping; raises on the
    all-zero (small-order) result like the OpenSSL binding does."""
    k = bytearray(private32)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    u = int.from_bytes(public32, "little") & ((1 << 255) - 1)
    out = _x25519_scalarmult(int.from_bytes(bytes(k), "little"), u)
    if out == 0:
        raise ValueError("x25519: low-order point")
    return out.to_bytes(32, "little")


class X25519PrivateKey:
    """Minimal stand-in for cryptography's X25519PrivateKey."""

    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(secrets.token_bytes(32))

    def public_key(self) -> "X25519PublicKey":
        # public = X25519(k, 9)
        base = (9).to_bytes(32, "little")
        return X25519PublicKey(x25519(self._raw, base))

    def exchange(self, peer: "X25519PublicKey") -> bytes:
        return x25519(self._raw, peer._raw)


class X25519PublicKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
        if len(raw) != 32:
            raise ValueError("x25519 public key must be 32 bytes")
        return cls(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw


# ---------------------------------------------------------------------------
# HKDF-SHA256 (RFC 5869)
# ---------------------------------------------------------------------------


def hkdf_sha256(ikm: bytes, length: int, info: bytes, salt: bytes | None = None) -> bytes:
    salt = salt or b"\x00" * 32
    prk = _hmac.new(salt, ikm, hashlib.sha256).digest()
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


# ---------------------------------------------------------------------------
# secp256k1 ECDSA (SEC1 + RFC 6979)
# ---------------------------------------------------------------------------

_SP = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_SN = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_SGX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_SGY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# Jacobian point: (X, Y, Z); the identity is Z == 0.
_J_ID = (0, 1, 0)


def _j_double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return _J_ID
    S = 4 * X * Y % _SP * Y % _SP
    M = 3 * X * X % _SP  # a == 0 for secp256k1
    X2 = (M * M - 2 * S) % _SP
    Y2 = (M * (S - X2) - 8 * pow(Y, 4, _SP)) % _SP
    Z2 = 2 * Y * Z % _SP
    return (X2, Y2, Z2)


def _j_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % _SP
    Z2Z2 = Z2 * Z2 % _SP
    U1 = X1 * Z2Z2 % _SP
    U2 = X2 * Z1Z1 % _SP
    S1 = Y1 * Z2 % _SP * Z2Z2 % _SP
    S2 = Y2 * Z1 % _SP * Z1Z1 % _SP
    if U1 == U2:
        if S1 != S2:
            return _J_ID
        return _j_double(p)
    H = (U2 - U1) % _SP
    R = (S2 - S1) % _SP
    HH = H * H % _SP
    HHH = HH * H % _SP
    V = U1 * HH % _SP
    X3 = (R * R - HHH - 2 * V) % _SP
    Y3 = (R * (V - X3) - S1 * HHH) % _SP
    Z3 = H * Z1 % _SP * Z2 % _SP
    return (X3, Y3, Z3)


def _j_mul(k: int, p):
    acc = _J_ID
    while k:
        if k & 1:
            acc = _j_add(acc, p)
        p = _j_double(p)
        k >>= 1
    return acc


def _j_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, _SP - 2, _SP)
    zi2 = zi * zi % _SP
    return (X * zi2 % _SP, Y * zi2 % _SP * zi % _SP)


def secp256k1_pub(d: int) -> bytes:
    """Compressed SEC1 public point d·G."""
    x, y = _j_affine(_j_mul(d, (_SGX, _SGY, 1)))
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress_secp(data: bytes):
    if len(data) != 33 or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= _SP:
        return None
    y2 = (pow(x, 3, _SP) + 7) % _SP
    y = pow(y2, (_SP + 1) // 4, _SP)
    if y * y % _SP != y2:
        return None
    if y & 1 != data[0] & 1:
        y = _SP - y
    return (x, y)


def _rfc6979_k(d: int, h1: bytes) -> int:
    """Deterministic nonce (RFC 6979 §3.2) with SHA-256."""
    x = d.to_bytes(32, "big")
    V = b"\x01" * 32
    K = b"\x00" * 32
    K = _hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
    V = _hmac.new(K, V, hashlib.sha256).digest()
    K = _hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
    V = _hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = _hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 0 < k < _SN:
            return k
        K = _hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = _hmac.new(K, V, hashlib.sha256).digest()


def secp256k1_sign(d: int, digest32: bytes) -> tuple[int, int]:
    """(r, s) over a prehashed message; the caller applies low-S."""
    z = int.from_bytes(digest32, "big") % _SN
    while True:
        k = _rfc6979_k(d, digest32)
        pt = _j_affine(_j_mul(k, (_SGX, _SGY, 1)))
        r = pt[0] % _SN
        if r == 0:
            digest32 = hashlib.sha256(digest32).digest()
            continue
        s = pow(k, _SN - 2, _SN) * ((z + r * d) % _SN) % _SN
        if s == 0:
            digest32 = hashlib.sha256(digest32).digest()
            continue
        return r, s


def secp256k1_verify(pub33: bytes, digest32: bytes, r: int, s: int) -> bool:
    pt = _decompress_secp(pub33)
    if pt is None or not (0 < r < _SN and 0 < s < _SN):
        return False
    z = int.from_bytes(digest32, "big") % _SN
    w = pow(s, _SN - 2, _SN)
    u1 = z * w % _SN
    u2 = r * w % _SN
    res = _j_add(_j_mul(u1, (_SGX, _SGY, 1)), _j_mul(u2, (*pt, 1)))
    aff = _j_affine(res)
    return aff is not None and aff[0] % _SN == r
