"""The port's sharded verifier (B6) on logical CPU shards, against the
JAX package's sharded kernels on its 8-device virtual CPU mesh
(tests/conftest.py provisions it).

The port's mesh is set by hand: `mesh._devices = [cpu] * k` runs k
shards one after another on the host, as XLA's virtual devices stand in
for chips in the reference's tests. Both packages get the same random
coefficients (the JAX host prep draws them from os.urandom, patched
here; the port's takes `rand_bytes`). Bitmaps and `eq_ok` must be equal;
partial points and folds are compared projectively (a shard's MSM may
associate its additions in another order). The reference's sharded
kernels are compiled once for the module (about 20 s each on a CPU), at
the 64 bucket; the port runs its plain versions, so most cases here use
two or three shards, eight where they are held against the reference.
"""

import os
import secrets

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu import testing as jtt
from tendermint_tpu.crypto import ed25519_math as em
from tendermint_tpu.crypto.tpu import curve as JC
from tendermint_tpu.crypto.tpu import field as JF
from tendermint_tpu.crypto.tpu import msm as JM
from tendermint_tpu.crypto.tpu import verify as JV
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import ed25519, sr25519
from tendermint_tpu_torch.crypto.cuda import curve as C
from tendermint_tpu_torch.crypto.cuda import field as F
from tendermint_tpu_torch.crypto.cuda import mesh
from tendermint_tpu_torch.crypto.cuda import verify as V

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = em.P
CHAIN_ID = "shard-chain"
N = 40
BAD = 11
N_DEV = 8


def _items(n: int, tag: bytes = b"eq", n_vals: int = 8):
    """n (pubkey, sign bytes, signature) triples of commits of one set."""
    vals, keys = jtt.make_validator_set(n_vals)
    items, h = [], 1
    while len(items) < n:
        bid = jtt.make_block_id(tag + b"%d" % h)
        c = jtt.make_commit(CHAIN_ID, h, 0, bid, vals, keys)
        items += [(vals.validators[i].pub_key.bytes(), c.vote_sign_bytes(CHAIN_ID, i), cs.signature)
                  for i, cs in enumerate(c.signatures)]
        h += 1
    return items[:n]


def _signed_items(n, tag=b"shard"):
    items = []
    for i in range(n):
        priv = ed25519.Ed25519PrivKey(secrets.token_bytes(32))
        msg = tag + b"-%d" % i
        items.append((priv.pub_key().bytes(), msg, priv.sign(msg)))
    return items


def _tamper(items, i, at=20):
    p, m, s = items[i]
    out = list(items)
    out[i] = (p, m, s[:at] + bytes([s[at] ^ 1]) + s[at + 1:])
    return out


def _ints(coords) -> list[int]:
    """X, Y, Z of a point (torch or numpy limbs) as integers mod p."""
    return [F.limbs_to_int(np.asarray(c)) for c in list(coords)[:3]]


def _same_point(a, b) -> bool:
    """Projective equality: X1·Z2 = X2·Z1 and Y1·Z2 = Y2·Z1."""
    (x1, y1, z1), (x2, y2, z2) = _ints(a), _ints(b)
    return z1 % P != 0 and (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


@pytest.fixture
def shards(monkeypatch):
    """shards(k): k logical CPU shards in the registry for this test."""
    return lambda k: monkeypatch.setattr(mesh, "_devices", [CPU] * k)


@pytest.fixture
def force_sharded(monkeypatch):
    """Drop the size gate: the sharded kernels take every chunk."""
    monkeypatch.setenv("TMTPU_FORCE_SHARDED", "1")


# -- (a), (b): the sharded kernels against the reference's, 8 shards ---------------


@pytest.fixture(scope="module")
def kernels():
    """A valid and a tampered 40-signature batch at the 64 bucket through
    the reference's sharded kernels on its 8-device mesh, and through the
    port's on 8 logical CPU shards (each shard's partial point kept), plus
    the port's single-device kernels on the tampered one."""
    assert len(jax.devices()) == N_DEV
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("data",))
    ref_eq, ref_sig = JV.make_sharded_kernel_eq(jmesh), JV.make_sharded_kernel(jmesh)
    port_eq = V.make_sharded_kernel_eq([CPU] * N_DEV)
    port_sig = V.make_sharded_kernel([CPU] * N_DEV)
    rng = np.random.default_rng(12)
    good = _items(N)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, items in (("good", good), ("bad", _tamper(good, BAD))):
            rnd = rng.bytes(16 * N)
            entries = [JV.resolve_ed25519(*it) for it in items]
            mp.setattr(os, "urandom", lambda n, rnd=rnd: rnd[:n])
            ops = JV.prepare_batch_eq(entries, pad_to=64)
            mp.undo()
            sig_ops = JV.prepare_resolved(entries, pad_to=64)
            j_bitmap, j_eq = ref_eq(*ops)
            partials = []
            local = V._local_partial
            mp.setattr(V, "_local_partial", lambda *a: partials.append(local(*a)) or partials[-1])
            bitmap, eq_ok = port_eq(*convert.batch_eq_operands(ops, "cpu"))
            mp.undo()
            out[name] = {
                "ops": ops,
                "ref": (np.asarray(j_bitmap), bool(j_eq), np.asarray(ref_sig(*sig_ops))),
                "port": (bitmap.numpy(), bool(eq_ok),
                         port_sig(*convert.resolved_operands(sig_ops, "cpu")).numpy()),
                "partials": partials,
            }
        bad_ops = out["bad"]["ops"]
        single_bitmap, single_eq = V.kernel_eq(*convert.batch_eq_operands(bad_ops, "cpu"))
        entries = [V.resolve_ed25519(*it) for it in _tamper(good, BAD)]
        single_sig = V.kernel_sig(*convert.resolved_operands(V.prepare_resolved(entries, pad_to=64),
                                                             "cpu"))
        out["single"] = (single_bitmap.numpy(), bool(single_eq), single_sig.numpy())
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["good", "bad"])
def test_sharded_kernel_eq_matches_reference(kernels, name):
    (j_bitmap, j_eq, _), (bitmap, eq_ok, _) = kernels[name]["ref"], kernels[name]["port"]
    assert eq_ok == j_eq == (name == "good")
    assert np.array_equal(bitmap, j_bitmap)


@pytest.mark.parametrize("name", ["good", "bad"])
def test_sharded_kernel_sig_matches_reference(kernels, name):
    j_sig, sig = kernels[name]["ref"][2], kernels[name]["port"][2]
    assert np.array_equal(sig, j_sig)
    assert sig[:N].sum() == N - (name == "bad") and not sig[N:].any()


@pytest.fixture(scope="module")
def ref_local():
    """The reference's per-shard computation (its `local_partial`:
    decompress, mask, msm.msm), compiled once at the 8-row shard."""

    def local(r_bytes, r_digits, s_valid):
        R, r_ok = JC.decompress(r_bytes.astype(jnp.int32))
        r_use = r_ok & s_valid
        Rm = JC.point_select(r_use, JC.point_neg(R), JC.identity((r_bytes.shape[0],)))
        return r_use, JM.msm(Rm, r_digits.astype(jnp.int32))

    return jax.jit(local)


@pytest.mark.parametrize("k", range(N_DEV))
def test_each_shards_partial_point_matches_reference_msm(kernels, ref_local, k):
    """Shard k's partial point (the tampered batch's, whose shards hold
    real, padding and invalid rows) is the reference's msm.msm over the
    same 8 rows, projectively; its R mask is the reference's."""
    _ua, r_bytes, _ga, r_digits, _zs, s_valid, _g = kernels["bad"]["ops"]
    lo, hi = 8 * k, 8 * k + 8
    j_use, j_part = ref_local(r_bytes[lo:hi], r_digits[:, lo:hi], s_valid[lo:hi])
    use, part = kernels["bad"]["partials"][k]
    assert np.array_equal(use.numpy(), np.asarray(j_use))
    assert _same_point(part, j_part)


def test_sharded_matches_single_device_on_the_same_operands(kernels):
    """8 shards against the port's single-device kernels on one batch
    with a corrupted row: the same bitmaps and eq_ok."""
    bitmap, eq_ok, sig = kernels["bad"]["port"]
    s_bitmap, s_eq, s_sig = kernels["single"]
    assert eq_ok == s_eq is False
    assert np.array_equal(bitmap, s_bitmap) and np.array_equal(sig, s_sig)


def test_a_short_shard_is_padded_onto_the_blocked_path(monkeypatch):
    """A 22-row shard (a 3-shard mesh at the 66 bucket) is padded to 32
    rows of which 10 are the identity, so its MSM runs the blocked path
    (B3's plain version): the same point as the 22-row MSM, which scans
    all points (and is held against the reference in test_torch_msm)."""
    from tendermint_tpu_torch.crypto.cuda import msm as M

    entries = [V.resolve_ed25519(*it) for it in _items(22, b"pad")]
    ops = convert.batch_eq_operands(V.prepare_batch_eq(entries, pad_to=22), "cpu")
    r_bytes, r_digits, s_valid = ops[1], ops[3], ops[5]
    scans = []
    plain = M._scan_blocks_plain
    monkeypatch.setattr(M, "_scan_blocks_plain", lambda f, r: scans.append(f.x.shape) or plain(f, r))
    use, part = V._local_partial(r_bytes, r_digits, s_valid)
    assert scans == [(16 * 2, 32)]  # 16 windows x 2 blocks of 16 rows
    monkeypatch.undo()
    R, r_ok = C.decompress(r_bytes.to(torch.int32))
    Rm = C.point_select(r_ok & s_valid, C.point_neg(R), C.identity((22,), CPU))
    assert use.all() and _same_point(part, M.msm(Rm, r_digits.to(torch.int32)))


# -- (c): the fold --------------------------------------------------------------------


def _points(n: int, seed: int) -> list[np.ndarray]:
    """n curve points k·B in extended coordinates (xz, yz, z, xyz) with a
    random z, as 4 × (n, 32) limb arrays."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in rng.integers(1, 2**40, n):
        p = em.BASE.scalar_mul(int(k))
        zi = pow(p.Z, P - 2, P)
        x, y, z = p.X * zi % P, p.Y * zi % P, int(rng.integers(2, 2**40))
        rows.append([JF.int_to_limbs(v * z % P) for v in (x, y, 1, x * y)])
    return [np.stack(c) for c in zip(*rows)]


@pytest.mark.parametrize("n_dev", [2, 3, 7, 8])
def test_reduce_partials_matches_reference(n_dev):
    coords = _points(n_dev, seed=n_dev)
    want = jax.jit(JV._reduce_partials)(JC.Point(*map(jnp.asarray, coords)))
    got = V._reduce_partials(convert.point(coords, "cpu"))
    assert _same_point(got, want)
    if n_dev in (3, 7):  # the chain folds in shard order, limb for limb
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


# -- (d): buckets and shard fill ------------------------------------------------------


@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 7, 8, 12])
def test_bucket_warm_bucket_and_shard_fill_match_reference(multiple):
    for n in (1, 20, 63, 64, 65, 81, 150, 2731, 5454, 8100, 8192):
        b = V._bucket(n, multiple)
        assert b == JV._bucket(n, multiple)
        for m in (b - 1, b, b + 1, 64, 96, 129, 8193):
            assert V._is_warm_bucket(m, multiple) == JV._is_warm_bucket(m, multiple)
        for n_dev in {multiple, 8}:
            if b % n_dev == 0:
                assert V._shard_fill(min(n, b), b, n_dev) == JV._shard_fill(min(n, b), b, n_dev)


# -- (e): the reference's sharded dispatch tests, on logical shards ------------------


def test_sharded_selected_for_large_batches(shards, monkeypatch):
    """Without an override, a batch that fills a floor bucket on every
    shard goes sharded; the kernels are cached by the exact device list,
    repeats included."""
    monkeypatch.delenv("TMTPU_FORCE_SHARDED", raising=False)
    shards(2)
    assert V._shard_device_count(CPU) == 2
    assert V._select_kernels(127, CPU).devices is None  # under 64 a shard
    items = _signed_items(V._MIN_BUCKET * 2, b"big")
    out = V.verify_batch_eq(items, "cpu")
    assert out.all() and len(out) == len(items)
    assert V.last_dispatch_info() == {"devices": ["cpu", "cpu"], "shards": [64, 64]}
    assert ("cpu", "cpu") in V._sharded_kernels
    assert V._get_sharded([CPU] * 3) is not V._get_sharded([CPU] * 2)


@pytest.fixture(scope="module")
def non_divisible():
    """81 signatures over 3 shards: the 128 bucket rounds up to 129, shards
    of 43. Returns (bitmap, last_dispatch_info)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TMTPU_FORCE_SHARDED", "1")
        mp.setattr(mesh, "_devices", [CPU] * 3)
        out = V.verify_batch_eq(_signed_items(81, b"nd"), "cpu")
        return out, V.last_dispatch_info()
    finally:
        mp.undo()


def test_sharded_all_valid_non_divisible(non_divisible):
    out, info = non_divisible
    assert out.all() and len(out) == 81
    assert V._bucket(81, 3) == 129 and info["shards"] == [43, 38, 0]


def test_shard_fill_and_dispatch_telemetry(non_divisible):
    """Real rows only, padding excluded, contiguous shards, one entry a
    shard though the logical shards share one device id."""
    _, info = non_divisible
    assert info == {"devices": ["cpu"] * 3, "shards": V._shard_fill(81, 129, 3)}
    assert sum(info["shards"]) == 81


@pytest.fixture(scope="module")
def attributed():
    """24 signatures, one corrupted, verified twice over 2 forced shards."""
    items = _tamper(_signed_items(24, b"bad"), 17, at=40)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TMTPU_FORCE_SHARDED", "1")
        mp.setattr(mesh, "_devices", [CPU] * 2)
        sig_calls = []
        kernel_sig = V.kernel_sig
        mp.setattr(V, "kernel_sig", lambda *ops: sig_calls.append(1) or kernel_sig(*ops))
        runs = [V.verify_batch_eq(items, "cpu") for _ in range(2)]
        return runs, sig_calls
    finally:
        mp.undo()


def test_sharded_bad_signature_attribution(attributed):
    """The batch equation fails; the sharded per-signature kernel (one
    kernel_sig a shard) attributes exactly the corrupted signature."""
    (out, _), sig_calls = attributed
    assert not out[17] and out.sum() == 23
    assert len(sig_calls) == 2 * 2  # two runs, two shards each


def test_sharded_same_seed_determinism(attributed):
    (out1, out2), _ = attributed
    assert np.array_equal(out1, out2) and not out1[17] and out1.sum() == 23


def test_sharded_mixed_sr25519(shards, force_sharded):
    """ed25519 and sr25519 resolve to the same Edwards-form check and ride
    one sharded MSM; a malformed entry stays False; a tampered sr25519
    signature is attributed by the sharded per-signature kernel."""
    shards(2)
    entries = []
    for i in range(5):
        priv = ed25519.Ed25519PrivKey(secrets.token_bytes(32))
        msg = b"mix-ed-%d" % i
        entries.append(V.resolve_ed25519(priv.pub_key().bytes(), msg, priv.sign(msg)))
    for i in range(5):
        priv = sr25519.Sr25519PrivKey(bytes([0x60 + i]) * 32)
        msg = b"mix-sr-%d" % i
        entries.append(V.resolve_sr25519(priv.pub_key().bytes(), msg, priv.sign(msg)))
    entries.append(None)
    out = V.verify_resolved(entries, "cpu")
    assert out[:10].all() and not out[10]

    priv = sr25519.Sr25519PrivKey(b"\x71" * 32)
    sig = bytearray(priv.sign(b"y"))
    sig[5] ^= 1
    entries[7] = V.resolve_sr25519(priv.pub_key().bytes(), b"y", bytes(sig))
    out = V.verify_resolved(entries, "cpu")
    assert not out[7] and not out[10] and out.sum() == 9


def test_sharded_matches_single_device_at_three_shards(kernels, shards, force_sharded):
    """Three shards (shards of 22 at the 66 bucket, the chain fold) give
    the single-device bitmap of the tampered batch, through the dispatch."""
    shards(3)
    entries = [V.resolve_ed25519(*it) for it in _tamper(_items(N), BAD)]
    out = V.verify_resolved(entries, "cpu")
    assert V.last_dispatch_info()["shards"] == [22, 18, 0]
    assert np.array_equal(out, kernels["single"][2][:N])
    assert not out[BAD] and out.sum() == N - 1


def test_bucket_guard():
    assert V._is_warm_bucket(64) and V._is_warm_bucket(128) and V._is_warm_bucket(8192)
    assert V._is_warm_bucket(64, 8) and V._is_warm_bucket(70, 7) and V._is_warm_bucket(8193, 3)
    assert not V._is_warm_bucket(65) and not V._is_warm_bucket(100)
    assert not V._is_warm_bucket(32) and not V._is_warm_bucket(96, 8)
    for n in (1, 63, 64, 65, 81, 150, 8100, 8192):
        for mult in (1, 3, 4, 7, 8):
            assert V._is_warm_bucket(V._bucket(n, mult), mult), (n, mult)


def test_dispatch_asserts_bucket_shape(monkeypatch):
    """A plan whose bucket is off the ladder raises before any launch."""
    bad = V._Selection(lambda *a: None, lambda *a: None, 100, None)
    monkeypatch.setattr(V, "_select_kernels", lambda n, d: bad)
    entries = [V.resolve_ed25519(*it) for it in _signed_items(4, b"guard")]
    with pytest.raises(RuntimeError, match="not a bucket"):
        V.verify_resolved(entries, "cpu")


# -- (f): no degrade ------------------------------------------------------------------


def test_a_failing_shard_makes_the_dispatch_raise(shards, force_sharded, monkeypatch):
    """A shard that fails raises out of verify_resolved and the batch
    verifier: no breaker, no smaller mesh, no host re-verify."""
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey

    shards(2)
    calls = []
    local = V._local_partial

    def failing(*ops):
        calls.append(1)
        if len(calls) % 2 == 0:
            raise RuntimeError("shard 1 failed")
        return local(*ops)

    monkeypatch.setattr(V, "_local_partial", failing)
    items = _signed_items(8, b"dead")
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        V.verify_resolved([V.resolve_ed25519(*it) for it in items], "cpu")
    monkeypatch.setattr(B, "MIN_TPU_BATCH", 1)
    bv = B.AdaptiveBatchVerifier("cpu")
    for pub, msg, sig in items:
        bv.add(Ed25519PubKey(pub), msg, sig)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        bv.verify()
    assert calls == [1, 1, 1, 1] and V._shard_device_count(CPU) == 2
    assert V.last_dispatch_info() is None


def test_no_stale_dispatch_info_after_an_unsharded_batch(shards, force_sharded, monkeypatch):
    """After a sharded dispatch, a batch on the same thread that dispatched
    nothing (empty, or every entry unresolvable) reports no shards: the
    verifier's last_dispatch, and so the hub's span, never carries an
    earlier batch's."""
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey

    shards(2)
    monkeypatch.setattr(B, "MIN_TPU_BATCH", 1)

    def run(items):
        bv = B.AdaptiveBatchVerifier("cpu")
        for pub, msg, sig in items:
            bv.add(Ed25519PubKey(pub), msg, sig)
        return bv.verify(), bv.last_dispatch

    (ok, _), disp = run(_signed_items(4, b"stale"))
    assert ok and disp == {"devices": ["cpu", "cpu"], "shards": [4, 0]}
    assert V.verify_resolved([], "cpu").shape == (0,) and V.last_dispatch_info() is None

    run(_signed_items(4, b"stale"))
    unresolvable = [(p, m, s[:32] + b"\xff" * 32) for p, m, s in _signed_items(3, b"s>=L")]
    (ok, results), disp = run(unresolvable)
    assert not ok and results == [False] * 3
    assert disp is None and V.last_dispatch_info() is None
