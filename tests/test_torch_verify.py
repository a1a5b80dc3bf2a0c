"""The port's device steps (`kernel_eq`, `kernel_sig`) and dispatch against
the JAX package's, on the CPU, at the 64-signature bucket.

Both sides get the same random coefficients: the JAX host prep draws them
from os.urandom (monkeypatched here), the port's takes `rand_bytes`. The
JAX kernels are compiled once for the module (about 40 s on a CPU), as
the reference's own dispatch jits them, so its `TPUBatchVerifier` reuses
the compilations."""

import os

import jax
import numpy as np
import pytest
import torch

from tendermint_tpu import testing as jtt
from tendermint_tpu.crypto.tpu import verify as JV
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto.cuda import verify as V

# the plain versions run on small tensors: one intra-op thread per process
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

CHAIN_ID = "eq-chain"
N = 40
BAD = 11


def _items(n: int, n_vals: int = 8):
    vals, keys = jtt.make_validator_set(n_vals)
    items = []
    h = 1
    while len(items) < n:
        bid = jtt.make_block_id(b"eq%d" % h)
        c = jtt.make_commit(CHAIN_ID, h, 0, bid, vals, keys)
        for i, cs in enumerate(c.signatures):
            items.append(
                (vals.validators[i].pub_key.bytes(), c.vote_sign_bytes(CHAIN_ID, i), cs.signature)
            )
        h += 1
    return items[:n]


def _tamper(items, i):
    p, m, s = items[i]
    out = list(items)
    out[i] = (p, m, s[:20] + bytes([s[20] ^ 1]) + s[21:])
    return out


def _jax_prep_eq(entries, rnd: bytes, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(os, "urandom", lambda n: rnd[:n])
        return JV.prepare_batch_eq(entries, pad_to=64)


@pytest.fixture(scope="module")
def cases():
    """(name, items, rand bytes, JAX outputs) for a valid and a tampered
    batch, both through one compile of each JAX kernel."""
    good = _items(N)
    bad = _tamper(good, BAD)
    rng = np.random.default_rng(31)
    kernel_eq = JV._get_kernel_eq()
    kernel_sig = JV._get_kernel()
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, items in (("good", good), ("bad", bad)):
            rnd = rng.bytes(16 * N)
            entries = [JV.resolve_ed25519(*it) for it in items]
            ops = _jax_prep_eq(entries, rnd, mp)
            bitmap, eq_ok = kernel_eq(*ops)
            sig = kernel_sig(*JV.prepare_resolved(entries, pad_to=64))
            out[name] = (items, rnd, ops, np.asarray(bitmap), bool(eq_ok), np.asarray(sig))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["good", "bad"])
def test_prepare_batch_eq_operands_identical(cases, name):
    items, rnd, ops, *_ = cases[name]
    entries = [V.resolve_ed25519(*it) for it in items]
    ours = V.prepare_batch_eq(entries, pad_to=64, rand_bytes=lambda n: rnd[:n])
    assert len(ours) == len(ops)
    for a, b in zip(ours, ops):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["good", "bad"])
def test_kernel_eq_bitmap_and_eq_ok_match_reference(cases, name):
    items, rnd, ops, j_bitmap, j_eq, _ = cases[name]
    bitmap, eq_ok = V.kernel_eq(*convert.batch_eq_operands(ops, "cpu"))
    assert bool(eq_ok) == j_eq == (name == "good")
    assert np.array_equal(bitmap.numpy(), j_bitmap)


@pytest.mark.parametrize("name", ["good", "bad"])
def test_kernel_sig_bitmap_matches_reference(cases, name):
    items, _, _, _, _, j_sig = cases[name]
    entries = [V.resolve_ed25519(*it) for it in items]
    got = V.kernel_sig(*convert.resolved_operands(V.prepare_resolved(entries, pad_to=64), "cpu"))
    assert np.array_equal(got.numpy(), j_sig)
    assert got[:N].sum().item() == N - (name == "bad")
    assert not got[N:].any()  # padding rows never verify


def test_verify_batch_eq_attributes_bad_and_malformed(cases):
    items = list(cases["bad"][0])
    items[2] = (items[2][0], items[2][1], items[2][2][:32] + (V.L + 9).to_bytes(32, "little"))
    items[5] = (b"\x01" * 31, items[5][1], items[5][2])  # short pubkey
    out = V.verify_batch_eq(items, "cpu")
    assert len(out) == N
    assert [i for i in range(N) if not out[i]] == [2, 5, BAD]


def test_verify_resolved_chunked(monkeypatch):
    """Batches above _MAX_BUCKET split into chunks; a bad signature is
    attributed within its own chunk only."""
    monkeypatch.setattr(V, "_MAX_BUCKET", 64)
    items = _tamper(_items(100), 70)
    sig_calls = []
    kernel_sig = V.kernel_sig
    monkeypatch.setattr(V, "kernel_sig", lambda *ops: sig_calls.append(1) or kernel_sig(*ops))
    out = V.verify_resolved([V.resolve_ed25519(*it) for it in items], "cpu")
    assert len(out) == 100
    assert not out[70] and out.sum() == 99
    assert sig_calls == [1]


def test_bucket_ladder_matches_reference():
    for n in (1, 63, 64, 65, 150, 4096, 5454, 8100, 8192):
        assert V._bucket(n) == JV._bucket(n)
    for g in (0, 1, 62, 63, 64, 150, 255, 256):
        assert V._group_bucket(g) == JV._group_bucket(g)
    for m in (32, 64, 96, 128, 8192, 8193):
        assert V._is_warm_bucket(m) == JV._is_warm_bucket(m)


def test_device_batch_verifier_interface(cases):
    """ed25519 entries through the batch kernels, any other key type on
    the host, one bitmap — the same as the reference's TPUBatchVerifier
    on a mixed batch with one valid and one invalid entry of each kind."""
    from tendermint_tpu.crypto.ed25519 import Ed25519PubKey as JEd25519PubKey
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey

    items = _items(6)
    bv = V.DeviceBatchVerifier("cpu", rand_bytes=lambda n: bytes(n))
    for p, m, s in items:
        bv.add(Ed25519PubKey(p), m, s)
    ok, results = bv.verify()
    assert ok and results == [True] * 6

    class OtherKey(Ed25519PubKey):
        TYPE = "secp256k1"

    class JOtherKey(JEd25519PubKey):
        TYPE = "secp256k1"

    bad = _tamper(_tamper(items, 2), 3)
    mixed = [(0, False), (1, True), (2, False), (3, True), (4, False)]  # (item, other key?)
    ours = V.DeviceBatchVerifier("cpu")
    ref = JV.TPUBatchVerifier()
    for i, other in mixed:
        p, m, s = bad[i]
        ours.add((OtherKey if other else Ed25519PubKey)(p), m, s)
        ref.add((JOtherKey if other else JEd25519PubKey)(p), m, s)
    got, want = ours.verify(), ref.verify()
    assert got == want == (False, [True, True, False, False, True])
    assert V.DeviceBatchVerifier("cpu").verify() == (False, [])
