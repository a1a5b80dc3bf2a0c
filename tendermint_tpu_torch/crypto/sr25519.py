"""sr25519 (schnorrkel) keys: Schnorr signatures over ristretto255 with
Merlin transcripts — the port's copy of tendermint_tpu/crypto/sr25519.py
(reference crypto/sr25519/{privkey,pubkey,batch}.go,
which delegate to curve25519-voi's schnorrkel implementation with an
EMPTY signing context, privkey.go:16).

Protocol stack, implemented bottom-up on the host:

  keccak-f[1600] → STROBE-128 (merlin's subset: meta-AD / AD / PRF)
  → Merlin transcript → schnorrkel sign/verify over ristretto255.

Signature = R ‖ s (64 bytes) with the schnorrkel version marker bit
(0x80) set in the last byte. Verification transcript:

  t = Transcript("SigningContext"); t.append("", ctx=b"")
  t.append("sign-bytes", msg); t.append("proto-name", "Schnorr-sig")
  t.append("sign:pk", pk); t.append("sign:R", R)
  k = t.challenge_scalar("sign:c");  accept iff s·B − k·A == R

The group math is the same twisted Edwards curve as ed25519 — ristretto255
is a quotient encoding of it — so BATCH verification reuses the card's
kernels: each (pk, msg, sig) is decoded from ristretto to an Edwards point
host-side, re-encoded in ed25519 compressed form, paired with the
transcript-derived challenge k, and fed to the same randomized
linear-combination step as ed25519 batches (`kernel_eq`,
crypto/cuda/verify.py). Its cofactored ×8 check is exact for ristretto:
the quotient ignores precisely the torsion that ×8 kills.

Ristretto255 encode/decode follow RFC 9496 §4.3. The mini-secret→keypair
expansion is framework-defined (no cross-implementation key-file interop
is claimed; signatures remain self-consistent and transcript-exact).
"""

from __future__ import annotations

import hashlib
import os

from . import ed25519_math as em
from . import PubKey, PrivKey, register_pubkey_type
from .hashes import sha256

KEY_TYPE = "sr25519"

P = em.P
L = em.L
D = em.D
SQRT_M1 = pow(2, (P - 1) // 4, P)

# -- keccak-f[1600] ----------------------------------------------------------

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """One permutation over 25 uint64 lanes (lane [x][y] at index x+5y)."""
    a = lanes
    for rc in _RC:
        # θ
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # ρ + π
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # χ
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # ι
        a[0] ^= rc
    return a


# -- STROBE-128 (merlin's subset) --------------------------------------------

_STROBE_R = 166
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_M = 1, 2, 4, 16


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = self._permute(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @staticmethod
    def _permute(st: bytearray) -> bytearray:
        lanes = [
            int.from_bytes(st[8 * i : 8 * i + 8], "little") for i in range(25)
        ]
        lanes = keccak_f1600(lanes)
        out = bytearray(200)
        for i, lane in enumerate(lanes):
            out[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")
        return out

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        self.state = self._permute(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("strobe: inconsistent `more` flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & _FLAG_C and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, False)
        return self._squeeze(n)

    def copy(self) -> "Strobe128":
        dup = object.__new__(Strobe128)
        dup.state = bytearray(self.state)
        dup.pos = self.pos
        dup.pos_begin = self.pos_begin
        dup.cur_flags = self.cur_flags
        return dup


class MerlinTranscript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n)

    def challenge_scalar(self, label: bytes) -> int:
        return int.from_bytes(self.challenge_bytes(label, 64), "little") % L

    def copy(self) -> "MerlinTranscript":
        dup = object.__new__(MerlinTranscript)
        dup.strobe = self.strobe.copy()
        return dup


# -- ristretto255 (RFC 9496 §4.3) --------------------------------------------


def _is_negative(x: int) -> bool:
    return x & 1 == 1


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """Returns (was_square, r) with r = sqrt(u/v) (nonneg) when u/v is
    square, else sqrt(i·u/v)."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_neg = (-u) % P
    correct = check == u % P
    flipped = check == u_neg
    flipped_i = check == u_neg * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    if _is_negative(r):
        r = P - r
    return correct or flipped, r


_INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)[1]


def ristretto_decode(data: bytes) -> em.Point | None:
    """Decode a 32-byte ristretto255 encoding to an Edwards point
    (a canonical coset representative); None if invalid."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = 2 * s % P * den_x % P
    if _is_negative(x):
        x = P - x
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return em.Point(x, y, 1, t)


def ristretto_encode(p: em.Point) -> bytes:
    """Encode an Edwards point as its 32-byte ristretto255 form."""
    x0, y0, z0, t0 = p.X, p.Y, p.Z, p.T
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_negative(t0 * z_inv % P):
        x, y = y0 * SQRT_M1 % P, x0 * SQRT_M1 % P
        den_inv = den1 * _INVSQRT_A_MINUS_D % P
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (-y) % P
    s = den_inv * ((z0 - y) % P) % P
    if _is_negative(s):
        s = P - s
    return s.to_bytes(32, "little")


# -- schnorrkel sign/verify ---------------------------------------------------

# the reference uses an empty signing context (privkey.go:16)
SIGNING_CONTEXT = b""


def signing_transcript(msg: bytes, ctx: bytes = SIGNING_CONTEXT) -> MerlinTranscript:
    t = MerlinTranscript(b"SigningContext")
    t.append_message(b"", ctx)
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge(t: MerlinTranscript, pub: bytes, r_bytes: bytes) -> int:
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub)
    t.append_message(b"sign:R", r_bytes)
    return t.challenge_scalar(b"sign:c")


def transcript_challenge(msg: bytes, pub: bytes, r_bytes: bytes) -> int:
    """The verification challenge k for (pub, msg, R) — used both by
    single verify and by the device batch path."""
    return _challenge(signing_transcript(msg), pub, r_bytes)


def _expand_mini_secret(seed: bytes) -> tuple[int, bytes]:
    """mini-secret (32B) → (scalar, nonce seed). Framework-defined
    expansion (module docstring)."""
    h = hashlib.sha512(b"sr25519-expand" + seed).digest()
    scalar = int.from_bytes(h[:32], "little") % L
    if scalar == 0:
        scalar = 1
    return scalar, h[32:]


def sign(seed: bytes, msg: bytes) -> bytes:
    scalar, nonce_seed = _expand_mini_secret(seed)
    pub_pt = em.BASE.scalar_mul(scalar)
    pub = ristretto_encode(pub_pt)
    t = signing_transcript(msg)
    # deterministic, message- and key-bound witness: clone the transcript,
    # bind the secret nonce seed, squeeze (schnorrkel's witness_bytes shape)
    tw = t.copy()
    tw.append_message(b"signing-nonce", nonce_seed)
    r = int.from_bytes(tw.challenge_bytes(b"witness", 64), "little") % L
    if r == 0:
        r = 1
    r_pt = em.BASE.scalar_mul(r)
    r_bytes = ristretto_encode(r_pt)
    k = _challenge(t, pub, r_bytes)
    s = (k * scalar + r) % L
    sig = bytearray(r_bytes + s.to_bytes(32, "little"))
    sig[63] |= 0x80  # schnorrkel version marker
    return bytes(sig)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pub) != 32:
        return False
    if not sig[63] & 0x80:
        return False  # unmarked (pre-schnorrkel) signature
    r_bytes = sig[:32]
    s_clear = bytearray(sig[32:])
    s_clear[31] &= 0x7F
    s = int.from_bytes(bytes(s_clear), "little")
    if s >= L:
        return False
    a_pt = ristretto_decode(pub)
    r_pt = ristretto_decode(r_bytes)
    if a_pt is None or r_pt is None:
        return False
    k = transcript_challenge(msg, pub, r_bytes)
    # s·B − k·A == R (as ristretto, i.e. up to torsion — exact here since
    # decoded representatives are torsion-free coset members)
    chk = em.BASE.scalar_mul(s).add(
        a_pt.scalar_mul(k).neg()
    )
    return ristretto_encode(chk) == r_bytes


def to_edwards_triple(
    pub: bytes, msg: bytes, sig: bytes
) -> tuple[bytes, bytes, int] | None:
    """Re-express an sr25519 (pub, msg, sig) for the ed25519 batch
    equation on the card: (A_edwards32, R_edwards32, k). None if
    malformed — the caller marks it invalid without consulting the
    device."""
    if len(sig) != 64 or len(pub) != 32 or not sig[63] & 0x80:
        return None
    a_pt = ristretto_decode(pub)
    r_pt = ristretto_decode(sig[:32])
    if a_pt is None or r_pt is None:
        return None
    return a_pt.compress(), r_pt.compress(), transcript_challenge(msg, pub, sig[:32])


# -- key classes (reference crypto/sr25519/{pubkey,privkey}.go) ---------------


class Sr25519PubKey(PubKey):
    TYPE = KEY_TYPE

    def __init__(self, data: bytes):
        if len(data) != 32:
            raise ValueError("sr25519 pubkey must be 32 bytes")
        self._data = bytes(data)

    def bytes(self) -> bytes:
        return self._data

    def address(self) -> bytes:
        return sha256(self._data)[:20]

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify(self._data, msg, sig)

    def __eq__(self, other) -> bool:
        return isinstance(other, Sr25519PubKey) and other._data == self._data

    def __hash__(self) -> int:
        return hash((KEY_TYPE, self._data))


class Sr25519PrivKey(PrivKey):
    TYPE = KEY_TYPE

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("sr25519 mini-secret must be 32 bytes")
        self._seed = bytes(seed)
        scalar, _ = _expand_mini_secret(seed)
        self._pub = ristretto_encode(
            em.BASE.scalar_mul(scalar)
        )

    @classmethod
    def generate(cls) -> "Sr25519PrivKey":
        return cls(os.urandom(32))

    def bytes(self) -> bytes:
        return self._seed

    def sign(self, msg: bytes) -> bytes:
        return sign(self._seed, msg)

    def pub_key(self) -> Sr25519PubKey:
        return Sr25519PubKey(self._pub)


register_pubkey_type(KEY_TYPE, Sr25519PubKey)
