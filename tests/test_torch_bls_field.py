"""The port's BLS12-381 tower (tendermint_tpu_torch/crypto/cuda/bls_field.py)
against the JAX reference (tendermint_tpu/crypto/tpu/bls_field.py), limb for
limb: the same numpy inputs through both, tolerance zero (exact integer
arithmetic). Inputs are random weak-normal limbs plus the edges: every limb
at 526 (the invariant's bound), every limb zero, p - 1, and a
non-canonical one. Each JAX function is jitted and called once, on all the
cases stacked.

Also: the constants written into csrc/bls12_381.cuh (p, the Montgomery
constants, the Frobenius and Frobenius^2 coefficients, the quotient
estimate's 2^336 / p, the x-chain's exponents) against crypto/bls_math.py,
and the Miller and hard-part bit schedules against the reference's.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls_math as RM
from tendermint_tpu.crypto.tpu import bls_field as R
from tendermint_tpu.crypto.tpu import bls_pairing as RP
from tendermint_tpu_torch.crypto import bls_math as M
from tendermint_tpu_torch.crypto.cuda import bls_field as F
from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

torch.set_num_threads(1)

HEADER = Path(F.__file__).resolve().parent / "csrc" / "bls12_381.cuh"


def _fp_cases(rng, n_random: int) -> np.ndarray:
    """(4 + n_random, 49): all 526, all 0, p - 1, p + 1 (a weak-normal
    one), then random limbs in [0, 526]."""
    edge = np.stack([
        np.full(F.LIMBS, 526, np.int32),
        np.zeros(F.LIMBS, np.int32),
        F.int_to_limbs(M.P - 1),
        np.frombuffer((M.P + 1).to_bytes(F.LIMBS, "little"), np.uint8).astype(np.int32),
    ])
    return np.concatenate([edge, rng.integers(0, 527, (n_random, F.LIMBS)).astype(np.int32)])


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(20261017)
    a = _fp_cases(rng, 12)  # (16, 49)
    b = np.concatenate([a[4:], a[:4]])  # every edge meets a random operand
    f12 = np.stack([
        np.full((6, 2, F.LIMBS), 526, np.int32),
        np.broadcast_to(a[3], (6, 2, F.LIMBS)) * np.array([1, 0] + [0] * 10).reshape(6, 2, 1),
        rng.integers(0, 527, (6, 2, F.LIMBS)).astype(np.int32),
        rng.integers(0, 527, (6, 2, F.LIMBS)).astype(np.int32),
    ]).astype(np.int32)
    return {"a": a, "b": b, "fq2_a": a.reshape(8, 2, F.LIMBS), "fq2_b": b.reshape(8, 2, F.LIMBS),
            "f12": f12, "f12_b": np.ascontiguousarray(f12[::-1])}


def _same(ref_fn, port_fn, *args):
    want = np.asarray(jax.jit(ref_fn)(*(jnp.asarray(x) for x in args)))
    got = port_fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in args)).numpy()
    assert got.dtype == np.int32 or got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mul", "square", "add", "sub", "neg", "canonical", "fp_inv"])
def test_fp_op_is_limb_exact_to_reference(cases, name):
    ops = {"mul": 2, "add": 2, "sub": 2}
    args = (cases["a"], cases["b"])[: ops.get(name, 1)]
    _same(getattr(R, name), getattr(F, name), *args)


@pytest.mark.parametrize("name", ["fq2_mul", "fq2_inv"])
def test_fq2_op_is_limb_exact_to_reference(cases, name):
    args = (cases["fq2_a"], cases["fq2_b"])[: 2 if name == "fq2_mul" else 1]
    _same(getattr(R, name), getattr(F, name), *args)


@pytest.mark.parametrize("name", ["f12_mul", "f12_frob2", "f12_conj", "f12_inv", "f12_is_one"])
def test_f12_op_is_limb_exact_to_reference(cases, name):
    args = (cases["f12"], cases["f12_b"])[: 2 if name == "f12_mul" else 1]
    _same(getattr(R, name), getattr(F, name), *args)


def test_f12_is_one_sees_a_non_canonical_one(cases):
    got = F.f12_is_one(torch.from_numpy(cases["f12"])).tolist()
    assert got == [False, True, False, False]


def test_host_conversions_match_reference():
    for v in (0, 1, M.P - 1, M.ZETA, 2**380 + 12345):
        np.testing.assert_array_equal(F.int_to_limbs(v), R.int_to_limbs(v))
        assert F.limbs_to_int(F.int_to_limbs(v)) == R.limbs_to_int(R.int_to_limbs(v))
    for name in ("M49", "M48", "OFFSET", "ONE"):
        np.testing.assert_array_equal(getattr(F, name), getattr(R, name))
    f = RM.pairing(RM.G1_GEN, RM.G2_GEN)
    assert F.f12_canonical_ints(F.f12_from_ints(f)) == f


def test_bit_schedules_match_reference():
    np.testing.assert_array_equal(BP.X_STEP_BITS, RP.X_STEP_BITS)
    np.testing.assert_array_equal(BP.HARD_STEP_BITS, RP.HARD_STEP_BITS)
    assert (len(BP.X_STEP_BITS), int(BP.X_STEP_BITS.sum())) == (63, 5)
    assert len(BP.HARD_STEP_BITS) == 1267


def _header_words(name: str) -> list[int]:
    text = HEADER.read_text()
    m = re.search(rf"{name}(\[[^\]]*\])+ = \{{(.*?)\}};", text, re.S)
    assert m, name
    return [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", m.group(2))]


def _words(v: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def _limbs(v: int) -> list[int]:
    return [(v >> (28 * i)) & 0xFFFFFFF for i in range(14)]


def test_kernel_header_constants_match_bls_math():
    """csrc/bls12_381.cuh carries p (as 12 words and as 14 limbs of 28
    bits) and its Montgomery constants (R = 2^392) as literals: each is
    checked here against bls_math's p."""
    p, r = M.P, 1 << 392
    assert _header_words("kP") == _words(p)
    assert _header_words("kPL") == _limbs(p)
    assert _header_words("kOne") == _limbs(r % p)
    assert _header_words("kR2") == _limbs(r * r % p)
    assert _header_words("kR3") == _limbs(r**3 % p)
    assert _header_words("kFrob2") == sum((_limbs(pow(M.ZETA, i, p) * r % p) for i in range(6)), [])
    # the p-Frobenius' conj(gamma_i), gamma_i = xi^(i (p - 1) / 6), (re, im) per i
    gammas = [M.q2_pow(M.XI, i * (p - 1) // 6) for i in range(6)]
    assert _header_words("kFrob1") == sum(
        (_limbs(c * r % p) for g in gammas for c in (g[0], -g[1] % p)), [])
    text = HEADER.read_text()
    pinv = int(re.search(r"kPInv = 0x([0-9a-f]+)u", text).group(1), 16)
    assert (pinv * p) % (1 << 28) == (1 << 28) - 1
    qinv = float(re.search(r"kQInv = ([0-9.e+-]+);", text).group(1))
    assert abs(qinv * p / 2**336 - 1) < 1e-15
    # the x-chain's exponents: |x| and k = -(x - 1) / 3
    assert int(re.search(r"kXAbs = 0x([0-9a-f]+)ull", text).group(1), 16) == -M.X_PARAM
    assert int(re.search(r"kChainK = 0x([0-9a-f]+)ull", text).group(1), 16) == (1 - M.X_PARAM) // 3
    assert M.P == RM.P and M.ZETA == RM.ZETA and M.X_PARAM == RM.X_PARAM
