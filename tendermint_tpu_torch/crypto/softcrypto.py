"""Pure-Python secp256k1 ECDSA for hosts without the OpenSSL-backed
`cryptography` package — the secp256k1 half of
tendermint_tpu/crypto/softcrypto.py, copied as it is: Jacobian
coordinates, RFC 6979 deterministic nonces (SHA-256), low-S
normalization left to the caller (crypto/secp256k1.py).

ChaCha20-Poly1305, X25519 and HKDF, the other half of the reference
module, belong to the p2p layer and are not ported yet."""

from __future__ import annotations

import hashlib
import hmac as _hmac

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
