"""BLS12-381 base-field and tower arithmetic on radix-2^8 limbs, in plain
PyTorch — the port of tendermint_tpu/crypto/tpu/bls_field.py.

An Fp element is an int32 tensor of shape (..., 49): limb i holds a
(partially reduced) coefficient of 256^i, every limb non-negative and at
most 526 ("weak-normal"). The functions keep the reference's limbs and
carry schedule step for step, so every result is limb-exact to the JAX
module, not just equal mod p (tests/test_torch_bls_field.py pins it).
What differs is how the exact sums are taken: the reference routes its
49x49 convolution and its high-limb fold through float32 GEMMs (exact on
the TPU's MXU); here the convolution is 49 shifted int32 multiply-adds
(every sum < 2^24), and the fold a float64 product (exact on any
device). torch has no int32 matmul on CUDA, and a float32 one may run in
TF32, so neither reference form is safe on the card.

The Fq2 / Fq12 tower mirrors crypto/bls_math.py: Fq2 = Fq[u]/(u^2+1) as
(..., 2, 49), Fq12 flat as Fq2[w]/(w^6 - (1+u)) with shape
(..., 6, 2, 49). This module is the plain version the pairing kernels
(crypto/cuda/bls_pairing.py, csrc/bls_*.cu) are held against; its
tensors may lie on the CPU or on the card.

Beside the reference's ops it carries the ones the kernels compute with
and the reference does not have: a general Fq12 squaring (`f12_sqr`),
the Granger-Scott squaring of the cyclotomic subgroup
(`f12_cyclotomic_sqr`), the p-power Frobenius (`f12_frob`) and the
product by a sparse Miller line (`f12_mul_line`). They are exact in
value (every result is weak-normal and equal mod p to the schoolbook
one), not limb for limb to anything in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls_math import P as P_INT, XI as XI_INT, ZETA as ZETA_INT, q2_pow

LIMBS = 49
WIDE = 2 * LIMBS - 1  # 97-limb convolution output


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> canonical 49-limb vector (numpy, host prep)."""
    return np.frombuffer(int(v % P_INT).to_bytes(LIMBS, "little"), dtype=np.uint8).astype(
        np.int32
    )


def limbs_to_int(a) -> int:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype=np.int64)
    return sum(int(x) << (8 * i) for i, x in enumerate(a)) % P_INT


ONE = int_to_limbs(1)

# fold rows: F_HI[i] = byte limbs of 2^(8*(49+i)) mod p, i < 51; row 0 is
# M49 = 2^392 mod p (limb 48 zero, so the scalar folds converge)
_F_HI = np.stack([int_to_limbs(pow(2, 8 * (LIMBS + i), P_INT)) for i in range(51)])
M49 = _F_HI[0].copy()
assert M49[48] == 0
# M48 = 2^384 mod p, canonical()'s byte-level fold
M48 = int_to_limbs(pow(2, 8 * 48, P_INT))

# subtraction offset: a multiple of p with every limb in [527, 782], so
# OFFSET - b stays non-negative limb-wise for any weak-normal b
_U = (2**392 - 1) // 255
_m = (527 * _U + P_INT - 1) // P_INT
_W = _m * P_INT - 527 * _U
assert 0 <= _W < 2**392
OFFSET = np.frombuffer(_W.to_bytes(LIMBS, "little"), dtype=np.uint8).astype(np.int32) + 527
assert OFFSET.min() >= 527 and OFFSET.max() <= 782

# P - 2 bits (MSB first, leading 1 dropped) for Fermat inversion
_PM2_BITS = [int(b) for b in bin(P_INT - 2)[3:]]

# Frobenius^2 coefficients zeta^i as limb rows (6, 49)
_FROB2 = np.stack([int_to_limbs(pow(ZETA_INT, i, P_INT)) for i in range(6)])

# Frobenius coefficients gamma_i = xi^(i (p - 1) / 6) in Fq2, limb rows
# (6, 2, 49): f^p conjugates coefficient i and multiplies it by gamma_i
GAMMA = tuple(q2_pow(XI_INT, i * (P_INT - 1) // 6) for i in range(6))
_FROB1 = np.stack([np.stack([int_to_limbs(g[0]), int_to_limbs(g[1])]) for g in GAMMA])

# canonical()'s comparison constants: bytes of 2^392 - k*p
_CMP = {
    k: np.frombuffer((2**392 - k * P_INT).to_bytes(LIMBS, "little"), dtype=np.uint8).astype(
        np.int32
    )
    for k in (8, 4, 2, 1)
}

_HOST = {
    "M49": M49,
    "M48_48": M48[:48],
    "OFFSET": OFFSET,
    "FROB2": _FROB2,
    "FROB1": _FROB1,
    "F_HI": _F_HI.astype(np.float64),
    **{f"CMP{k}": v for k, v in _CMP.items()},
}
_consts: dict[tuple[str, torch.device], torch.Tensor] = {}


def _c(name: str, device) -> torch.Tensor:
    key = (name, torch.device(device))
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.from_numpy(_HOST[name]).to(device)
    return t


def _carry_pass(c: torch.Tensor) -> torch.Tensor:
    """One plain carry pass over the last axis (no modular fold): keep the
    low byte, push the high bits one limb up; the top limb's carry is
    dropped, so callers provide headroom."""
    out = c & 0xFF
    out[..., 1:] += (c >> 8)[..., :-1]
    return out


def _carry_fold(c: torch.Tensor) -> torch.Tensor:
    """One carry pass over 49 limbs with the 2^392 wrap: the carry out of
    limb 48 folds back as carry * M49."""
    out = c & 0xFF
    hi = c >> 8
    out[..., 1:] += hi[..., :48]
    out += hi[..., 48:49] * _c("M49", c.device)
    return out


def weak_reduce(c: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Restore the weak-normal invariant (limbs <= 526): three passes for
    limbs < 2^13, two for a plain a + b of weak-normal inputs."""
    for _ in range(passes):
        c = _carry_fold(c)
    return c


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return weak_reduce(a + b, 2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p through the +OFFSET trick."""
    return weak_reduce(a + _c("OFFSET", a.device) - b, 3)


def neg(a: torch.Tensor) -> torch.Tensor:
    return weak_reduce(_c("OFFSET", a.device) - a, 3)


def _conv(a: torch.Tensor, b: torch.Tensor, width: int = WIDE) -> torch.Tensor:
    """The exact product convolution of two (..., 49) limb vectors, as
    `width` limbs (the 97 of the product, then zeros): one shifted
    multiply-add per limb of `a`. Products are <= 526^2 and every sum
    < 2^24, so int32 holds them exactly."""
    out = torch.zeros(a.shape[:-1] + (width,), dtype=torch.int32, device=a.device)
    for i in range(LIMBS):
        out[..., i : i + LIMBS].addcmul_(a[..., i : i + 1], b)
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply, the reference's schedule: convolution, three carry
    passes over 100 limbs, the fold of the high 51 limbs through F_HI,
    three more passes, and two scalar folds of limb 49. Inputs
    weak-normal; output limbs <= 511."""
    a, b = torch.broadcast_tensors(a, b)
    c = _carry_pass(_carry_pass(_carry_pass(_conv(a, b, WIDE + 3))))
    fold = (c[..., LIMBS:].to(torch.float64) @ _c("F_HI", c.device)).to(torch.int32)
    c = torch.cat([c[..., :LIMBS] + fold, torch.zeros_like(c[..., :3])], -1)
    c = _carry_pass(_carry_pass(_carry_pass(c)))
    m49 = _c("M49", c.device)
    c = torch.cat([c[..., :LIMBS] + c[..., LIMBS : LIMBS + 1] * m49, c[..., :1] * 0], -1)
    c = _carry_pass(_carry_pass(c))
    return c[..., :LIMBS] + c[..., LIMBS : LIMBS + 1] * m49


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def fp_inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) by square-and-multiply over the constant bit string (the
    multiply only where a bit is set: the reference computes both and
    selects, with the same limbs)."""
    acc = a
    for bit in _PM2_BITS:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, a)
    return acc


def _scan_carry(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential carry along the limb axis: (byte limbs, the carry
    out of limb 48)."""
    carry = torch.zeros_like(c[..., 0])
    out = []
    for i in range(c.shape[-1]):
        v = c[..., i] + carry
        out.append(v & 0xFF)
        carry = v >> 8
    return torch.stack(out, -1), carry


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the canonical bytes of [0, p) (limb 48 zero): two
    2^392-folds, four byte-level 2^384-folds, then conditional
    subtractions of 8p, 4p, 2p and p."""
    dev = a.device
    m49 = _c("M49", dev)
    v = a
    for _ in range(2):
        v, c = _scan_carry(v)
        v = v + c[..., None] * m49
    v, _ = _scan_carry(v)
    m48 = _c("M48_48", dev)
    for _ in range(4):
        v = torch.cat([v[..., :48] + v[..., 48:49] * m48, torch.zeros_like(v[..., 48:])], -1)
        v, _ = _scan_carry(v)
    for k in (8, 4, 2, 1):
        w, carry = _scan_carry(v + _c(f"CMP{k}", dev))
        v = torch.where((carry > 0)[..., None], w, v)
    return v


# -- Fq2 = Fq[u]/(u^2+1): shape (..., 2, 49) ---------------------------------


def _sub_and_sum(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Stack (sub's pre-reduction sum d, a plain sum s) on axis -2 and
    reduce them as the reference does, d three passes and s two, in one
    set of tensor ops."""
    c = weak_reduce(torch.stack([d, s], -2), 2)
    return torch.cat([_carry_fold(c[..., :1, :]), c[..., 1:, :]], -2)


def fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook, the four Fq products in one mul call:
    (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    m = mul(torch.stack([a0, a0, a1, a1], -2), torch.stack([b0, b1, b0, b1], -2))
    return _sub_and_sum(
        m[..., 0, :] + _c("OFFSET", a.device) - m[..., 3, :], m[..., 1, :] + m[..., 2, :]
    )


def fq2_neg(a):
    return weak_reduce(_c("OFFSET", a.device) - a, 3)


def fq2_conj(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 0, :], neg(a[..., 1, :])], -2)


def fq2_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + (2 a0) a1 u: two Fq products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return mul(torch.stack([add(a0, a1), add(a0, a0)], -2), torch.stack([sub(a0, a1), a1], -2))


def fq2_inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 - a1 u) / (a0^2 + a1^2): one Fp inversion."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    ninv = fp_inv(add(mul(a0, a0), mul(a1, a1)))
    return torch.stack([mul(a0, ninv), mul(neg(a1), ninv)], -2)


def fq2_scale(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """An Fq2 element (..., 2, 49) times an Fp scalar (..., 49)."""
    return mul(a, s[..., None, :])


# -- Fq12 flat: Fq2[w]/(w^6 - (1+u)), shape (..., 6, 2, 49) ------------------


def f12_one(batch_shape: tuple = (), device="cpu") -> torch.Tensor:
    one = np.zeros(tuple(batch_shape) + (6, 2, LIMBS), np.int32)
    one[..., 0, 0, :] = ONE
    return torch.from_numpy(one).to(device)


def _mul_by_xi(c: torch.Tensor) -> torch.Tensor:
    """(r + i u)(1 + u) = (r - i) + (r + i) u on (..., 2, 49)."""
    r, i = c[..., 0, :], c[..., 1, :]
    return _sub_and_sum(r + _c("OFFSET", c.device) - i, r + i)


def _fold(conv: torch.Tensor) -> torch.Tensor:
    """An 11-coefficient product over Fq2 (raw limb sums below 2^13) ->
    the Fq12 with w^6 = xi, reduced as f12_mul reduces."""
    lo = conv[..., :6, :, :]
    lo[..., :5, :, :] += _mul_by_xi(weak_reduce(conv[..., 6:, :, :], 3))
    return weak_reduce(lo, 3)


def f12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Degree-6 polynomial product over Fq2 with the w^6 = xi fold; the
    36 Fq2 cross-products go through one stacked fq2_mul, and the
    coefficients' reductions run stacked too (each coefficient gets the
    reference's passes)."""
    a, b = torch.broadcast_tensors(a, b)
    A, B = torch.broadcast_tensors(a[..., :, None, :, :], b[..., None, :, :, :])
    prod = fq2_mul(A, B)  # (..., 6, 6, 2, 49)
    conv = prod.new_zeros(prod.shape[:-4] + (11, 2, LIMBS))
    for i in range(6):
        conv[..., i : i + 6, :, :] += prod[..., i, :, :, :]  # raw sums <= 6 * 526
    return _fold(conv)


_PAIRS = [(i, j) for i in range(6) for j in range(i + 1, 6)]


def f12_sqr(a: torch.Tensor) -> torch.Tensor:
    """General Fq12 squaring, 21 Fq2 products (the 15 cross products a_i
    a_j, i < j, each counted twice, and the 6 squares) in place of
    f12_mul's 36; f need not be in the cyclotomic subgroup."""
    i, j = zip(*_PAIRS)
    cross = fq2_mul(a[..., list(i), :, :], a[..., list(j), :, :])  # (..., 15, 2, 49)
    sq = fq2_sqr(a)
    conv = a.new_zeros(a.shape[:-3] + (11, 2, LIMBS))
    for n, (x, y) in enumerate(_PAIRS):
        conv[..., x + y, :, :] += 2 * cross[..., n, :, :]
    conv[..., 0:11:2, :, :] += sq  # raw sums <= 7 * 526
    return _fold(conv)


def _three_minus_two(v: torch.Tensor, old: torch.Tensor, sign: int) -> torch.Tensor:
    """3 v + 2 sign old, sign = +-1."""
    two_old = add(old, old)
    return add(add(v, v), add(v, two_old) if sign > 0 else sub(v, two_old))


def f12_cyclotomic_sqr(a: torch.Tensor) -> torch.Tensor:
    """a^2 for a in the cyclotomic subgroup (a^(p^4 - p^2 + 1) = 1), or
    zero, by Granger and Scott: Fq12 as Fq4[w]/(w^3 - s), s = w^3, so a =
    z0 + z1 w + z2 w^2 with z0 = (a0, a3), z1 = (a1, a4), z2 = (a2, a5)
    (flat coefficients). Each Fq4 square (x + y s)^2 = (x^2 + xi y^2) +
    ((x + y)^2 - x^2 - y^2) s is three Fq2 squarings: nine in all, 18 Fq
    products. On any other element the result is not a^2."""
    x, y = a[..., 0:3, :, :], a[..., 3:6, :, :]  # the three pairs (a_q, a_q+3)
    sq = fq2_sqr(torch.stack([x, y, add(x, y)], -4))  # (..., 3 which, 3 pairs, 2, 49)
    t0, t1, s = sq[..., 0, :, :, :], sq[..., 1, :, :, :], sq[..., 2, :, :, :]
    c0 = add(_mul_by_xi(t1), t0)
    c1 = sub(sub(s, t0), t1)
    c1 = torch.cat([c1[..., :2, :, :], _mul_by_xi(c1[..., 2:, :, :])], -3)
    first = _three_minus_two(c0, a[..., [0, 2, 4], :, :], -1)  # new a0, a2, a4
    second = _three_minus_two(c1, a[..., [3, 5, 1], :, :], 1)  # new a3, a5, a1
    return torch.stack([first[..., 0, :, :], second[..., 2, :, :], first[..., 1, :, :],
                        second[..., 0, :, :], first[..., 2, :, :], second[..., 1, :, :]], -3)


def f12_frob(a: torch.Tensor) -> torch.Tensor:
    """f^p: coefficient i conjugated in Fq2, then times gamma_i."""
    return fq2_mul(fq2_conj(a), _c("FROB1", a.device))


def f12_mul_line(f: torch.Tensor, py: torch.Tensor, c3: torch.Tensor, l5: torch.Tensor):
    """f times the sparse Miller line py w^0 + c3 w^3 + l5 w^5 (py in Fq
    (..., 49); c3, l5 in Fq2 (..., 2, 49); l5 = a5 px): 12 Fq products by
    py and 12 Fq2 products, 48 Fq products in all."""
    a = mul(f, py[..., None, None, :])
    bc = fq2_mul(f[..., None, :, :, :], torch.stack([c3, l5], -3)[..., :, None, :, :])
    b, c = bc[..., 0, :, :, :], bc[..., 1, :, :, :]
    b = torch.cat([_mul_by_xi(b[..., 3:, :, :]), b[..., :3, :, :]], -3)  # w^(i+3)
    c = torch.cat([_mul_by_xi(c[..., 1:, :, :]), c[..., :1, :, :]], -3)  # w^(i+5)
    return weak_reduce(a + b + c, 3)


def f12_conj(a: torch.Tensor) -> torch.Tensor:
    """f^(p^6): negate the odd-w coefficients."""
    return torch.stack(
        [fq2_neg(a[..., i, :, :]) if i % 2 else a[..., i, :, :] for i in range(6)], -3
    )


def f12_frob2(a: torch.Tensor) -> torch.Tensor:
    """f^(p^2): coefficient i times zeta^i (constants in Fq)."""
    return mul(a, _c("FROB2", a.device)[:, None, :])


def f12_inv(a: torch.Tensor) -> torch.Tensor:
    """Norm-based inversion: the product of the five Frobenius^2
    conjugates times a lands in Fq2."""
    g = f12_frob2(a)
    acc = g
    for _ in range(4):
        g = f12_frob2(g)
        acc = f12_mul(acc, g)
    n = f12_mul(a, acc)
    ninv = fq2_inv(n[..., 0, :, :])
    return fq2_mul(acc, ninv[..., None, :, :])


def f12_canonical_ints(a: torch.Tensor) -> tuple:
    """One Fq12 tensor (6, 2, 49) -> bls_math's 12-int tuple."""
    c = canonical(a).cpu().numpy()
    return tuple(limbs_to_int(c[i, j]) for i in range(6) for j in range(2))


def f12_from_ints(f: tuple, device="cpu") -> torch.Tensor:
    """bls_math's 12-int tuple -> a canonical (6, 2, 49) tensor."""
    return torch.from_numpy(np.stack([int_to_limbs(x) for x in f]).reshape(6, 2, LIMBS)).to(
        device
    )


def f12_is_one(a: torch.Tensor) -> torch.Tensor:
    """Elementwise (over the leading batch dims) comparison with 1."""
    target = canonical(f12_one((), a.device))
    return (canonical(a) == target).all(-1).all(-1).all(-1)
