"""GF(2^255-19) arithmetic on tensors of radix-2^8 limbs, in int32.

The port of tendermint_tpu/crypto/tpu/field.py, with the same public
layout: a field element is an int32 tensor of shape (..., 32), limb i
holding a (partially reduced) coefficient of 256^i. Invariant between
operations: |limbs| < 2^9 (`mul`, `sub`, `neg`, `mul_scalar` return
limbs ≤ 293; `add` returns ≤ 369). Limbs can dip slightly below zero:
EIGHT_P is the reference's, whose `int_to_limbs(P_INT)` reduces p to 0,
so `sub` and `neg` add 0, not 8p; the integer arithmetic (and the
kernels) carry signed limbs exactly, and values stay right mod p. The carry
schedule is the reference's (four passes after a multiply, two after a
subtraction, one after an addition), so results are limb-identical to the
JAX package, not just equal mod p.

Kernels in this module (CUDA C++, csrc/):

  B1 `mul` → csrc/fe_mul.cu, replacing pallas_field._mul_limbs_first.
  B2 `pow22523` → csrc/fe_pow22523.cu, replacing
     pallas_field._pow22523_limbs_first.

Both use the shuffle-free multiply of csrc/fe25519_group.cuh (as does
B3, msm.scan_blocks, with its batched forms): four lanes own one field
element, eight limbs each in registers, and exchange operands and
carries through shared memory, never through warp shuffles; the convolution runs in exact FP32 FFMA (every accumulator
sums at most 8 products, below 2^22) and the fold and the four carry
passes in int32, so the limbs are the plain version's.
What bounds them on an H100: a lone multiply moves 384 bytes for ~2,500
operations (6.5 per byte, under the card's ~20 per byte), so B1 is bound
by bytes and stages its operands through shared memory with coalesced
16-byte copies; the pow22523 chain does 262 multiplies per 256 bytes
moved, so B2 is bound by operations and keeps the whole chain in one
launch, no intermediate touching device memory. Tensor cores do not fit
(no operand is shared across elements; see the header). On the main
path B1's cost is the host side of its ~1,000 small launches, so its
wrapper does no more than checks and one ctypes call when the operands
already qualify.

On a CUDA tensor `mul` and `pow22523` launch their kernel or raise; the
plain PyTorch versions (`_mul_plain`, `_pow22523_plain`) run only for
tensors on the CPU, and beside the kernels on the card to check them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as tnf

from . import _build

LIMBS = 32
P_INT = 2**255 - 19
D_INT = (-121665 * pow(121666, P_INT - 2, P_INT)) % P_INT
SQRT_M1_INT = pow(2, (P_INT - 1) // 4, P_INT)


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> canonical limb vector (numpy, for constants/host prep)."""
    return np.frombuffer(int(v % P_INT).to_bytes(32, "little"), dtype=np.uint8).astype(
        np.int32
    )


def limbs_to_int(a) -> int:
    """Limb vector (possibly partially reduced) -> Python int mod p."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype=np.int64)
    return sum(int(x) << (8 * i) for i, x in enumerate(a)) % P_INT


P_LIMBS = int_to_limbs(P_INT)
D_LIMBS = int_to_limbs(D_INT)
D2_LIMBS = int_to_limbs(2 * D_INT)
SQRT_M1_LIMBS = int_to_limbs(SQRT_M1_INT)
ONE = int_to_limbs(1)
# the reference's "8p": int_to_limbs reduces p mod p, so this is all zeros
# (kept for limb identity; see the module docstring)
EIGHT_P = (8 * P_LIMBS).astype(np.int32)

_CONSTS = {
    "one": ONE,
    "d": D_LIMBS,
    "d2": D2_LIMBS,
    "sqrt_m1": SQRT_M1_LIMBS,
    "eight_p": EIGHT_P,
}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_CONSTS[name]).to(device)


def const(name: str, device) -> torch.Tensor:
    """A (32,) limb constant ("one", "d", "d2", "sqrt_m1", "eight_p") on
    `device`, copied there once."""
    return _const(name, torch.device(device))


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no field arithmetic for tensors on {t.device}")


def _carry_pass(c: torch.Tensor) -> torch.Tensor:
    """One carry: keep the low byte, push the high bits one limb up; the
    carry out of limb 31 wraps to limb 0 times 38 (2^256 ≡ 38)."""
    hi = c >> 8
    return (c & 0xFF) + torch.cat([hi[..., 31:] * 38, hi[..., :31]], dim=-1)


# -- B1: field multiply ------------------------------------------------------

FE_MUL = _build.Kernel(
    "fe_mul",
    "fe_mul",
    [_build.P, _build.I32, _build.P, _build.I32, _build.P, _build.I64, _build.I32, _build.P],
    replaces="tendermint_tpu/crypto/tpu/pallas_field.py:183",
)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply. Inputs: |limbs| < 2^9. Output: limbs ≤ 293."""
    if on_card(a):
        return _mul_cuda(a, b)
    return _mul_plain(a, b)


def _check(t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() == 0 or t.shape[-1] != LIMBS:
        raise ValueError(f"expected (..., 32) int32 limbs, got {t.dtype} {tuple(t.shape)}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    _check(t)
    return t.reshape(-1, LIMBS).contiguous()


def _operand(t: torch.Tensor, shape: torch.Size) -> tuple[torch.Tensor, int]:
    """(tensor, row step) that B1 and B2 read as rows of `shape`: the
    tensor itself when it is contiguous and 16-byte aligned — with step
    32, or step 0 when it is one element broadcast to every row — else a
    contiguous copy. The kernels never see a stride they do not take."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        if t.shape == shape:
            return t, LIMBS
        if t.numel() == LIMBS:
            return t, 0
    return t.expand(shape).clone(memory_format=torch.contiguous_format), LIMBS


def _mul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a)
    _check(b)
    if b.get_device() != a.get_device():
        raise ValueError(f"operands on {a.device} and {b.device}")
    shape = a.shape if a.shape == b.shape else torch.broadcast_shapes(a.shape, b.shape)
    out = a.new_empty(shape)
    m = out.numel() // LIMBS
    if m:
        a, a_step = _operand(a, shape)
        b, b_step = _operand(b, shape)
        FE_MUL(a.data_ptr(), a_step, b.data_ptr(), b_step, out.data_ptr(), m,
               *_build.stream_args(out))
    return out


def _mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B1's plain version: the 32×32 schoolbook convolution in int32
    (every partial sum < 2^23, exact), the fold 2^256 ≡ 38, four carry
    passes. The convolution sums anti-diagonals of the outer product by
    skewing row i right by i (pad each row to 65, re-cut rows at 64)."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[:-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 32, 32), ≤ 511²
    skew = tnf.pad(outer, (0, LIMBS + 1)).reshape(*batch, LIMBS * (2 * LIMBS + 1))
    skew = skew[..., : LIMBS * 2 * LIMBS].reshape(*batch, LIMBS, 2 * LIMBS)
    conv = skew.sum(dim=-2, dtype=torch.int32)  # (..., 64); conv[63] == 0
    c = conv[..., :LIMBS] + 38 * conv[..., LIMBS:]
    for _ in range(4):
        c = _carry_pass(c)
    return c


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_many(pairs: list[tuple[torch.Tensor, torch.Tensor]]) -> list[torch.Tensor]:
    """Multiply several independent pairs with ONE `mul` call (one kernel
    launch) by stacking them along a new leading axis."""
    lhs, rhs = [], []
    for a, b in pairs:
        a, b = torch.broadcast_tensors(a, b)
        lhs.append(a)
        rhs.append(b)
    out = mul(
        torch.stack(torch.broadcast_tensors(*lhs)),
        torch.stack(torch.broadcast_tensors(*rhs)),
    )
    return list(out.unbind(0))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b with one carry pass: inputs < 2^9 → output ≤ 369."""
    return _carry_pass(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p, non-negative limbs via +8p, then two carry passes."""
    return _carry_pass(_carry_pass(a + const("eight_p", a.device) - b))


def neg(a: torch.Tensor) -> torch.Tensor:
    return _carry_pass(_carry_pass(const("eight_p", a.device) - a))


def mul_scalar(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant (k ≤ 16)."""
    return _carry_pass(_carry_pass(a * k))


# -- B2: z^(2^252 - 3) ---------------------------------------------------------

FE_POW22523 = _build.Kernel(
    "fe_pow22523",
    "fe_pow22523",
    [_build.P, _build.P, _build.I64, _build.I32, _build.P],
    replaces="tendermint_tpu/crypto/tpu/pallas_field.py:281",
)


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^(2^252 - 3): the exponentiation used for inverse square roots in
    decompression (classic ed25519 addition chain)."""
    if on_card(z):
        _check(z)
        out = z.new_empty(z.shape)
        m = out.numel() // LIMBS
        if m:
            z, _ = _operand(z, z.shape)
            FE_POW22523(z.data_ptr(), out.data_ptr(), m, *_build.stream_args(out))
        return out
    return _pow22523_plain(z)


def _pow22523_plain(z: torch.Tensor) -> torch.Tensor:
    """B2's plain version: the same chain over `_mul_plain`."""

    def sq(x, k=1):
        for _ in range(k):
            x = _mul_plain(x, x)
        return x

    t0 = sq(z)  # 2
    t1 = sq(t0, 2)  # 8
    t1 = _mul_plain(z, t1)  # 9
    t0 = _mul_plain(t0, t1)  # 11
    t0 = sq(t0)  # 22
    t0 = _mul_plain(t1, t0)  # 31 = 2^5 - 1
    t1 = sq(t0, 5)
    t0 = _mul_plain(t1, t0)  # 2^10 - 1
    t1 = sq(t0, 10)
    t1 = _mul_plain(t1, t0)  # 2^20 - 1
    t2 = sq(t1, 20)
    t1 = _mul_plain(t2, t1)  # 2^40 - 1
    t1 = sq(t1, 10)
    t0 = _mul_plain(t1, t0)  # 2^50 - 1
    t1 = sq(t0, 50)
    t1 = _mul_plain(t1, t0)  # 2^100 - 1
    t2 = sq(t1, 100)
    t1 = _mul_plain(t2, t1)  # 2^200 - 1
    t1 = sq(t1, 50)
    t0 = _mul_plain(t1, t0)  # 2^250 - 1
    t0 = sq(t0, 2)  # 2^252 - 4
    return _mul_plain(t0, z)  # 2^252 - 3


# -- exact reduction (host-side torch code, no kernel) ---------------------------


def _scan_carry(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential carry along the limb axis (batch-vectorized).
    Returns (byte limbs, carry out of limb 31)."""
    out = torch.empty_like(c)
    carry = torch.zeros_like(c[..., 0])
    for i in range(LIMBS):
        v = c[..., i] + carry
        out[..., i] = v & 0xFF
        carry = v >> 8
    return out, carry


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the canonical byte representation in [0, p)."""
    v, carry = _scan_carry(a)
    # fold 2^256-carries back in; after two folds the carry is exhausted
    v[..., 0] += carry * 38
    v, carry = _scan_carry(v)
    v[..., 0] += carry * 38
    v, carry = _scan_carry(v)
    # v < 2^256 now; subtract p (conditionally) twice via the +19 trick:
    # v >= p  iff  v + 19 >= 2^255
    for _ in range(2):
        w = v.clone()
        w[..., 0] += 19
        w, wcarry = _scan_carry(w)
        ge = (wcarry > 0) | (w[..., 31] >= 0x80)
        w[..., 31] &= 0x7F  # w - 2^255 == v - p
        v = torch.where(ge.unsqueeze(-1), w, v)
    return v


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """a ≡ 0 (mod p), elementwise over the batch. Returns bool (...,)."""
    return (canonical(a) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


def parity(a: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical representation."""
    return canonical(a)[..., 0] & 1
