"""The port's MSM against the JAX package's and the integer oracle, on the
CPU: M = 64 takes the blocked path (kernel B3's plain version), M = 40 the
scan over all points. Results are compared projectively — the block-total
scan may associate additions in another order than jax.lax.associative_scan
— and against exact integer arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_math as em
from tendermint_tpu.crypto.tpu import curve as JC
from tendermint_tpu.crypto.tpu import field as JF
from tendermint_tpu.crypto.tpu import msm as JM
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto.cuda import curve as C
from tendermint_tpu_torch.crypto.cuda import field as F
from tendermint_tpu_torch.crypto.cuda import msm as M

# the plain versions run on small tensors: one intra-op thread per process
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

P = em.P
N_WINDOWS = 4  # 32-bit scalars keep the reference's compile and the oracle cheap


def _case(m: int, seed: int):
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**30, m)]
    pts = [em.BASE.scalar_mul(k) for k in ks]
    rows = []
    for p in pts:
        zi = pow(p.Z, P - 2, P)
        x, y = p.X * zi % P, p.Y * zi % P
        rows.append([JF.int_to_limbs(v) for v in (x, y, 1, x * y % P)])
    coords = [np.stack(c) for c in zip(*rows)]
    digits = rng.integers(0, 256, (N_WINDOWS, m), dtype=np.int32)
    digits[:, :3] = 0  # digit-0 points cancel; keep some
    digits[0, 3:6] = 255
    scalars = [sum(int(digits[w, i]) << (8 * w) for w in range(N_WINDOWS)) for i in range(m)]
    oracle = em.BASE.scalar_mul(sum(k * s for k, s in zip(ks, scalars)) % em.L)
    return coords, digits, oracle


def _affine(x, y, z):
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


@pytest.mark.parametrize("m,blocked", [(64, True), (40, False)])
def test_msm_vs_reference_and_oracle(m, blocked, monkeypatch):
    coords, digits, oracle = _case(m, seed=m)
    want = jax.jit(JM.msm)(JC.Point(*map(jnp.asarray, coords)), jnp.asarray(digits))

    scans = []
    plain = M._scan_blocks_plain
    monkeypatch.setattr(M, "_scan_blocks_plain", lambda f, r: scans.append(1) or plain(f, r))
    got = M.msm(convert.point(coords, "cpu"), torch.from_numpy(digits))
    assert bool(scans) == blocked

    g = [F.limbs_to_int(c) for c in got[:3]]
    w = [JF.limbs_to_int(np.asarray(c)) for c in want[:3]]
    # projective: X1·Z2 = X2·Z1 and Y1·Z2 = Y2·Z1
    assert (g[0] * w[2] - w[0] * g[2]) % P == 0
    assert (g[1] * w[2] - w[1] * g[2]) % P == 0
    assert _affine(*g) == _affine(oracle.X, oracle.Y, oracle.Z)


def test_window_sums_blocked_vs_scan_path():
    """The blocked prefix path and the all-points scan give the same
    window sums for the same sorted input (M = 64 both ways)."""
    coords, digits, _ = _case(64, seed=7)
    pts = convert.point(coords, "cpu")
    d = torch.from_numpy(digits)
    blocked = M._window_sum(pts, d)
    # a 64-point batch padded with one identity row has M = 65: scan path
    ident = [np.zeros((1, 32), np.int32), JF.ONE[None], JF.ONE[None], np.zeros((1, 32), np.int32)]
    padded = convert.point([np.concatenate([c, i]) for c, i in zip(coords, ident)], "cpu")
    scanned = M._window_sum(padded, torch.cat([d, torch.zeros((N_WINDOWS, 1), dtype=d.dtype)], 1))
    for w in range(N_WINDOWS):
        a = [F.limbs_to_int(c[w]) for c in blocked[:3]]
        b = [F.limbs_to_int(c[w]) for c in scanned[:3]]
        assert _affine(*a) == _affine(*b)


def test_scan_blocks_plain_vs_reference_scan_at_extreme_limbs():
    """B3's plain version, limb for limb, against the reference's lax.scan
    of curve.add_cached (msm.py:146-152), whose `sub` adds EIGHT_P = 0 —
    the arithmetic the CUDA kernel must match — on chains where adding
    the true 8p (the Pallas kernel's `_eight_p`) would part ways: one at
    511 in every limb, one with negative limbs, one with y == x."""
    rng = np.random.default_rng(31)
    chains, steps = 4, M._BLOCK - 1
    first = [rng.integers(0, 512, (chains, 32), dtype=np.int32) for _ in range(4)]
    rest = [rng.integers(0, 512, (steps, chains, 32), dtype=np.int32) for _ in range(4)]
    for c in first:
        c[0] = 511
        c[1] = rng.integers(-300, 0, 32)
    for c in rest:
        c[:, 0] = 511
        c[:, 1] = rng.integers(-300, 0, (steps, 32))
    first[1][3] = first[0][3]  # y == x

    def step(acc, nxt):
        acc = JC.add_cached(acc, nxt)
        return acc, acc

    _, tail = jax.jit(lambda f, r: jax.lax.scan(step, f, r))(
        JC.Point(*map(jnp.asarray, first)), JC.CachedPoint(*map(jnp.asarray, rest))
    )
    got = M._scan_blocks_plain(
        C.Point(*map(torch.from_numpy, first)), C.CachedPoint(*map(torch.from_numpy, rest))
    )
    for f, t, g in zip(first, tail, got):
        want = np.concatenate([f[:, None], np.moveaxis(np.asarray(t), 0, 1)], 1)
        assert np.array_equal(g.numpy(), want)
    assert (got.x.numpy() < 0).any()  # the signed limbs the kernel must carry


@pytest.mark.parametrize("bad", ["steps", "chains", "device"])
def test_scan_operands_refuses_mismatched_inputs(bad):
    """B3's wrapper checks all eight operands before its kernel reads
    them: one shape of chains and steps, and one device."""
    first = C.Point(*(torch.zeros((6, 32), dtype=torch.int32) for _ in range(4)))
    rest = C.CachedPoint(*(torch.zeros((3, 6, 32), dtype=torch.int32) for _ in range(4)))
    ins, chains, steps = M._scan_operands(first, rest)
    assert (chains, steps, len(ins)) == (6, 3, 8)
    if bad == "steps":
        rest = rest._replace(ypx=rest.ypx[:2])
    elif bad == "chains":
        first = first._replace(z=first.z[:5])
    else:
        rest = rest._replace(t2d=rest.t2d.to("meta"))
    with pytest.raises(ValueError):
        M._scan_operands(first, rest)
