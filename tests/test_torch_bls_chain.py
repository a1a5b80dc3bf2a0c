"""The arithmetic that the redesigned pairing kernels (K7a csrc/bls_miller.cu,
K7b csrc/bls_final_exp.cu) and their plain versions share, on the CPU:
the x-chain of the final exponentiation's hard part, the Granger-Scott
squaring, the p-power Frobenius, the general squaring, the sparse line
product, and the pad-lane and one-lane skips. Inputs are drawn from a
numpy seed; every comparison is exact.

The JAX graph (tendermint_tpu/crypto/tpu/bls_pairing.py _build_kernel)
emits canonical(its value) with is_one beside it, and its value is
bls_math's (the reference's own tests pin that); its final exponentiation
alone takes ~16 s to compile and run on a CPU. So the port's outputs are held
against bls_math's values and, limb for limb, against the reference's
jitted `canonical` and `f12_is_one` of those values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls_math as RM
from tendermint_tpu.crypto.tpu import bls_field as R
from tendermint_tpu_torch import testing as tt
from tendermint_tpu_torch.crypto import bls_math as M
from tendermint_tpu_torch.crypto.cuda import bls_field as F
from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

torch.set_num_threads(1)


def _rand_ints(rng, n: int) -> list:
    return [tuple(int.from_bytes(rng.bytes(48), "little") % M.P for _ in range(12)) for _ in range(n)]


def _tensor(fs) -> torch.Tensor:
    return torch.stack([F.f12_from_ints(f) for f in fs])


def _ints(t: torch.Tensor) -> tuple:
    return F.f12_canonical_ints(t)


def _cyclotomic(fs) -> list:
    """f^((p^6 - 1)(p^2 + 1)): the easy part's output, in the subgroup."""
    out = []
    for f in fs:
        f1 = M.f12_mul(M.f12_conj(f), M.f12_inv(f))
        out.append(M.f12_mul(M.f12_frob2(f1), f1))
    return out


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20261017)


def test_chain_exponent_identity_and_cost():
    """d = (p^4 - p^2 + 1) / r = ((x - 1)^2 / 3)(x + p)(x^2 + p^2 - 1) + 1 as
    integers, the kernel's constants are |x| and -(x - 1) / 3, and the
    chain is 314 squarings and 52 multiplies against the scan's 1,267
    and 632."""
    x, p = M.X_PARAM, M.P
    assert (x - 1) % 3 == 0 and x < 0
    d = (p**4 - p**2 + 1) // M.R
    assert d == ((x - 1) ** 2 // 3) * (x + p) * (x * x + p * p - 1) + 1
    assert BP.CHAIN_K == -(x - 1) // 3 == 0x460055555555AAAB
    assert BP.X_ABS == -x == 0xD201000000010000

    def cost(e):
        return e.bit_length() - 1, bin(e).count("1") - 1

    (sk, mk), (sx, mx) = cost(BP.CHAIN_K), cost(BP.X_ABS)
    assert (sk + 4 * sx, mk + 4 * mx + 5) == (314, 52)
    assert (len(BP.HARD_STEP_BITS), int(BP.HARD_STEP_BITS.sum())) == (1267, 632)
    assert int("1" + "".join(map(str, BP.HARD_STEP_BITS)), 2) == d


@pytest.fixture(scope="module")
def final_exp_cases(rng):
    """Two random elements, one, zero, p - 1 in every Fp; each as a lone
    lane, through the plain K7b."""
    fs = _rand_ints(rng, 2) + [M.F12_ONE, M.F12_ZERO, (M.P - 1,) * 12]
    ok, out = BP._final_exp_plain(_tensor(fs)[:, None])
    return fs, ok, out


def test_plain_final_exp_on_the_x_chain_equals_bls_math(final_exp_cases):
    fs, ok, out = final_exp_cases
    want = [M.final_exp(f) for f in fs]
    assert [_ints(o) for o in out] == want
    assert ok.tolist() == [w == M.F12_ONE for w in want] == [False, False, True, False, False]
    assert want[3] == M.F12_ZERO  # zero stays zero, and is not one


def test_plain_final_exp_is_limb_exact_to_the_reference_canonical_form(final_exp_cases):
    fs, ok, out = final_exp_cases
    vals = np.stack([F.f12_from_ints(RM.final_exp(f)).numpy() for f in fs])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax.jit(R.canonical)(jnp.asarray(vals))))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jax.jit(R.f12_is_one)(jnp.asarray(vals))))


def test_hard_part_equals_the_reference_scan(rng):
    g = _cyclotomic(_rand_ints(rng, 2))
    got = BP.hard_part(_tensor(g))
    assert [_ints(x) for x in got] == [M.f12_pow(x, M.HARD_BITS) for x in g]


def test_cyclotomic_sqr_is_the_square_in_the_subgroup(rng):
    g = _cyclotomic(_rand_ints(rng, 3)) + [M.F12_ONE, M.F12_ZERO]
    got = F.f12_cyclotomic_sqr(_tensor(g))
    assert [_ints(x) for x in got] == [M.f12_mul(x, x) for x in g]
    # elsewhere it is not the square: the chain relies on the easy part
    f = _rand_ints(rng, 1)[0]
    assert _ints(F.f12_cyclotomic_sqr(_tensor([f]))[0]) != M.f12_mul(f, f)


def test_frob_is_the_p_power(rng):
    fs = _rand_ints(rng, 2) + [(M.P - 1,) * 12]
    got = F.f12_frob(_tensor(fs))
    assert [_ints(x) for x in got] == [M.f12_pow(f, bin(M.P)[2:]) for f in fs]
    assert F.GAMMA == tuple(M.q2_pow(M.XI, i * (M.P - 1) // 6) for i in range(6))


def test_general_sqr_equals_mul_on_weak_normal_limbs(rng):
    fs = _tensor(_rand_ints(rng, 2))
    weak = torch.from_numpy(rng.integers(0, 527, (2, 6, 2, F.LIMBS)).astype(np.int32))
    for a in (fs, weak):
        assert torch.equal(F.canonical(F.f12_sqr(a)), F.canonical(F.f12_mul(a, a)))
    assert int(F.f12_sqr(weak).max()) <= 526


def test_sparse_line_product_equals_f12_mul_by_the_line(rng):
    f = _tensor(_rand_ints(rng, 3))
    pts = _tensor(_rand_ints(rng, 3))
    px, py, a5, c3 = pts[:, 0, 0], pts[:, 0, 1], pts[:, 1], pts[:, 2]
    line = BP._line_f12(a5, c3, px, py)
    got = F.f12_mul_line(f, py, c3, F.fq2_scale(a5, px))
    assert torch.equal(F.canonical(got), F.canonical(F.f12_mul(f, line)))


def _miller_batch():
    """A (1, 3) bucket: a real pair, a pad pair, and a lane with py = 1
    whose lines are not zero (not a pad)."""
    q = M.hash_to_point_g2(b"chain-pad")
    ins = [torch.from_numpy(a) for a in BP.prepare_pairing_batch([[(M.G1_GEN, q)]], 2, 4)[0]]
    ins = [t[:1, :3].contiguous() if t.dim() == 3 else t[:, :1, :3].contiguous() for t in ins]
    for t in ins[2:]:
        t[:, 0, 2] = t[:, 0, 0]
    ins[0][0, 2] = ins[0][0, 0]
    ins[1][0, 2] = torch.from_numpy(F.ONE)
    return q, ins


def test_pad_lane_miller_value_is_exactly_one():
    q, ins = _miller_batch()
    assert BP.pad_lanes(*ins[1:]).tolist() == [[False, True, False]]
    out = BP._miller_plain(*ins)
    assert torch.equal(out[0, 1], F.f12_one())
    assert _ints(out[0, 0]) == M.miller_loop(M.G1_GEN, M.prepare_lines(q))
    assert _ints(out[0, 2]) == M.miller_loop((M.G1_GEN[0], 1), M.prepare_lines(q))


def test_pairing_bucket_holds_real_pairs_then_pads():
    """testing.make_pairing_bucket (the card tests' and the timing
    script's buckets): item i's first real[i] lanes are real pairs, lane
    (i, j) the pair (i + j) % 8 of the pool, and the rest pad pairs."""
    real = [3, 1, 0]
    ins = tt.make_pairing_bucket(real, 4, "cpu")
    assert [tuple(t.shape) for t in ins] == [(3, 4, 49)] * 2 + [(63, 3, 4, 2, 49)] * 4
    assert BP.pad_lanes(*ins[1:]).tolist() == [[j >= n for j in range(4)] for n in real]
    q = M.hash_to_point_g2(b"k7-%d" % 2)
    out = BP._miller_plain(*ins)
    assert _ints(out[0, 2]) == M.miller_loop(M.g1_mul(M.G1_GEN, 5), M.prepare_lines(q))


def test_lane_product_skips_exact_ones_whatever_their_place(rng):
    """Lanes of one among others, an odd count of the rest, a zero lane:
    the product over the pair axis equals bls_math's."""
    fs = _rand_ints(rng, 3)
    lanes = [[M.F12_ONE, fs[0], M.F12_ONE, fs[1], fs[2], M.F12_ONE, M.F12_ONE, M.F12_ONE],
             [fs[0], M.F12_ZERO] + [M.F12_ONE] * 6,
             [M.F12_ONE] * 8]
    got = BP._lane_product(torch.stack([_tensor(item) for item in lanes]))
    for g, item in zip(got, lanes):
        want = M.F12_ONE
        for f in item:
            want = M.f12_mul(want, f)
        assert _ints(g) == want
