"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card every test here skips (the check runs
inside a fixture, not at import). On a machine with one (--noconftest:
tests/conftest.py imports jax, which these tests do not need):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Integer arithmetic: every comparison is exact (torch.equal). Shapes
include ragged edges the kernels mask themselves (element counts that
are not multiples of B1's and B2's 32 elements per block, chain counts
that are not multiples of B3's two chains per block), no element at
all, the all-511 worst case of the FP32 convolution (and, for B3, of the
8p that the reference's arithmetic adds as zero), limbs below zero, and
operands the wrappers must copy (a transposed view, a misaligned view)
or read in place (a broadcast constant). The BLS kernels (K7a
bls_miller, K7b bls_final_exp) run on pairing buckets of real pairs and
of p - 1 in every input with zero lines and pad pairs; K7b is also held
against bls_math.final_exp, and on an item whose product is zero. The
pairing buckets include the paths' own, (2, 256) and (128, 2). B8
(sha256_bytes) runs on 1 to 16,384 messages (around its 32 a thread
block and the reference's buckets) of lengths across the padding edges
mixed in each launch, packed after a prefix of n % 16 bytes so that
messages start at every alignment, and is held against hashlib too; it
refuses a misaligned buffer, and the words-level `sha256_batch` has no
kernel. The sharded batch equation (B6) runs over 4 and 3 logical shards
of the card and is held against the unsharded one.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import testing as tt
from tendermint_tpu_torch.crypto import bls_math as BM
from tendermint_tpu_torch.crypto.cuda import bls_field as BF
from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
from tendermint_tpu_torch.crypto.cuda import curve as C
from tendermint_tpu_torch.crypto.cuda import field as F
from tendermint_tpu_torch.crypto.cuda import msm as M

# the plain versions run on small tensors: one intra-op thread per process
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _limbs(rng, *shape, device):
    return torch.from_numpy(rng.integers(0, 512, shape + (32,), dtype=np.int32)).to(device)


@pytest.mark.parametrize("m", [1, 3, 5, 4099, 31, 33, 64, 8193])
def test_fe_mul_kernel_equals_plain(card, m):
    rng = np.random.default_rng(m)
    a, b = _limbs(rng, m, device=card), _limbs(rng, m, device=card)
    a[0], b[0] = 511, 511
    before = F.FE_MUL.launches
    got = F.mul(a, b)
    assert F.FE_MUL.launches == before + 1
    assert torch.equal(got, F._mul_plain(a, b))
    # broadcast against a constant, and a stacked (4, m) batch
    assert torch.equal(F.mul(a, F.const("d", card)), F._mul_plain(a, F.const("d", card)))
    stacked = torch.stack([a, b, a, b])
    assert torch.equal(F.mul(stacked, stacked.flip(0)), F._mul_plain(stacked, stacked.flip(0)))


@pytest.mark.parametrize("m", [1, 7, 513, 33, 8447])
def test_fe_pow22523_kernel_equals_plain(card, m):
    rng = np.random.default_rng(100 + m)
    z = _limbs(rng, m, device=card)
    before = F.FE_POW22523.launches
    got = F.pow22523(z)
    assert F.FE_POW22523.launches == before + 1
    assert torch.equal(got, F._pow22523_plain(z))


def _scan_inputs(rng, chains, steps, kind, device):
    """B3's operands with limbs in [0, 512) ("random"), [-300, 300)
    ("signed") or all 511 ("all511"); chain 1, where there is one, has
    y == x."""
    lo, hi = {"random": (0, 512), "signed": (-300, 300), "all511": (511, 512)}[kind]

    def draw(*shape):
        return torch.from_numpy(rng.integers(lo, hi, shape + (32,), dtype=np.int32)).to(device)

    first = C.Point(*(draw(chains) for _ in range(4)))
    if chains > 1:
        first.y[1] = first.x[1]
    return first, C.CachedPoint(*(draw(steps, chains) for _ in range(4)))


@pytest.mark.parametrize(
    "chains,steps,kind",
    [
        (1, 15, "random"), (5, 15, "random"), (130, 15, "random"), (6, 3, "random"),
        (7, 15, "random"), (9, 15, "signed"), (513, 15, "signed"), (4, 0, "random"),
        (512, 15, "random"), (512, 15, "signed"), (9, 15, "all511"),
    ],
)
def test_scan_blocks_kernel_equals_plain(card, chains, steps, kind):
    """Chain counts that leave B3's last block (two chains) half empty
    (1, 5, 7, 9, 513), the A side's 512, no step at all; one launch per
    call."""
    rng = np.random.default_rng(200 + chains)
    first, rest = _scan_inputs(rng, chains, steps, kind, card)
    before = M.SCAN_BLOCKS.launches
    got = M.scan_blocks(first, rest)
    assert M.SCAN_BLOCKS.launches == before + 1
    want = M._scan_blocks_plain(first, rest)
    for g, w in zip(got, want):
        assert g.shape == (chains, steps + 1, 32)
        assert torch.equal(g, w)


def test_kernels_refuse_wrong_dtype(card):
    x = torch.zeros((4, 32), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        F.mul(x, x)
    with pytest.raises(ValueError):
        F.pow22523(x)
    y = torch.zeros((4, 31), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        F.mul(y, y)
    with pytest.raises(ValueError):
        F.pow22523(y)
    z = torch.zeros((4, 32), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        F.mul(z, z.cpu())


@pytest.mark.parametrize("m", [1, 33, 8192])
def test_worst_case_all_511(card, m):
    """Every limb 511 in every row: the largest convolution coefficients
    (511^2 * 32 < 2^23), where the FP32 sums are closest to inexact, for
    the product (B1) and for the squarings that open B2's chain; and m
    chains of 15 steps of B3, where a sub that adds the true 8p (as the
    Pallas kernel does) leaves other limbs than the plain version's."""
    x = torch.full((m, 32), 511, dtype=torch.int32, device=card)
    assert torch.equal(F.mul(x, x), F._mul_plain(x, x))
    assert torch.equal(F.pow22523(x), F._pow22523_plain(x))
    first = C.Point(x, x, x, x)
    rest = C.CachedPoint(*(x.expand(15, m, 32) for _ in range(4)))
    for g, w in zip(M.scan_blocks(first, rest), M._scan_blocks_plain(first, rest)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m", [5, 4099])
def test_signed_limbs(card, m):
    """Limbs below zero, as `sub` and `neg` leave them (the reference's
    EIGHT_P is 0): the plain versions compute them exactly in int32, and
    so must the kernels' FP32 convolution and signed carries."""
    rng = np.random.default_rng(600 + m)
    a = torch.from_numpy(rng.integers(-511, 512, (m, 32), dtype=np.int32)).to(card)
    b = torch.from_numpy(rng.integers(-120, 300, (m, 32), dtype=np.int32)).to(card)
    a[0], b[0] = -511, -511
    a[1], b[1] = -511, 511
    assert torch.equal(F.mul(a, b), F._mul_plain(a, b))
    assert torch.equal(F.mul(a, a), F._mul_plain(a, a))
    assert torch.equal(F.pow22523(a), F._pow22523_plain(a))
    # B3 on chains of such limbs (|limb| <= 511 in, as for every multiply)
    first = C.Point(a, b, b.flip(0), a.flip(0))
    rest = C.CachedPoint(*(torch.stack([a.roll(k + j, 0) for j in range(15)]) for k in range(4)))
    for g, w in zip(M.scan_blocks(first, rest), M._scan_blocks_plain(first, rest)):
        assert torch.equal(g, w)


def test_empty_batch_launches_nothing(card):
    x = torch.zeros((0, 32), dtype=torch.int32, device=card)
    before = (F.FE_MUL.launches, F.FE_POW22523.launches)
    got_mul, got_pow = F.mul(x, x), F.pow22523(x)
    assert (F.FE_MUL.launches, F.FE_POW22523.launches) == before
    assert got_mul.shape == (0, 32) and got_pow.shape == (0, 32)
    assert F.mul(x, F.const("d", card)).shape == (0, 32)


@pytest.mark.parametrize("m", [5, 40])
def test_strided_and_misaligned_operands(card, m):
    """Operands the kernels cannot read as they lie are copied first:
    a transposed view (not contiguous) and a contiguous view that starts
    4 bytes into its storage (not 16-byte aligned). Neither is read
    wrong, nor is the input changed."""
    rng = np.random.default_rng(400 + m)
    wide = rng.integers(0, 512, (32, m), dtype=np.int32)
    t = torch.from_numpy(wide).to(card).t()  # (m, 32), not contiguous
    assert not t.is_contiguous()
    flat = _limbs(rng, m + 1, device=card).reshape(-1)
    odd = flat[1 : 1 + 32 * m].view(m, 32)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    before_t, before_odd = t.clone(), odd.clone()
    for a, b in ((t, odd), (odd, t), (t, F.const("d", card)), (F.const("d", card), odd)):
        assert torch.equal(F.mul(a, b), F._mul_plain(a, b))
    assert torch.equal(F.pow22523(t), F._pow22523_plain(t))
    assert torch.equal(F.pow22523(odd), F._pow22523_plain(odd))
    assert torch.equal(t, before_t) and torch.equal(odd, before_odd)


def test_broadcast_shapes(card):
    """Broadcasting beyond a single constant row: (4, 1, m) against
    (1, 3, m), and a (1, 32) row against (m, 32)."""
    rng = np.random.default_rng(500)
    a = _limbs(rng, 4, 1, 7, device=card)
    b = _limbs(rng, 1, 3, 7, device=card)
    got = F.mul(a, b)
    assert got.shape == (4, 3, 7, 32)
    assert torch.equal(got, F._mul_plain(a, b))
    row = _limbs(rng, 1, device=card)
    c = _limbs(rng, 9, device=card)
    assert torch.equal(F.mul(row, c), F._mul_plain(row, c))
    assert torch.equal(F.mul(c, row), F._mul_plain(c, row))


def test_scan_blocks_wrapper_copies_or_refuses(card):
    """B3 reads its operands with 16-byte copies: a transposed view and
    a misaligned view are copied first (and read right); an operand on
    another device, or of another shape, is refused, launching nothing."""
    rng = np.random.default_rng(700)
    chains, steps = 9, 15
    first, rest = _scan_inputs(rng, chains, steps, "signed", card)
    want = M._scan_blocks_plain(first, rest)
    wide = first.x.t().contiguous().t()  # (9, 32), not contiguous
    flat = torch.cat([first.z.new_zeros(1), first.z.reshape(-1)])
    odd = flat[1:].view(chains, 32)  # contiguous, 4 bytes past 16-byte alignment
    assert not wide.is_contiguous() and odd.data_ptr() % 16 != 0
    got = M.scan_blocks(first._replace(x=wide, z=odd), rest)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = M.SCAN_BLOCKS.launches
    with pytest.raises(ValueError):
        M.scan_blocks(first, rest._replace(t2d=rest.t2d.cpu()))
    with pytest.raises(ValueError):
        M.scan_blocks(first, rest._replace(z2=rest.z2[:, :-1]))
    with pytest.raises(ValueError):
        M.scan_blocks(first._replace(t=first.t.to(torch.int64)), rest)
    assert M.SCAN_BLOCKS.launches == before


def test_msm_on_card_is_limb_identical_to_cpu(card):
    """The whole MSM (both paths) on the card, through the kernels, gives
    the very limbs the CPU run of the plain versions gives."""
    rng = np.random.default_rng(300)
    for m in (64, 40):
        pts = [rng.integers(0, 512, (m, 32), dtype=np.int32) for _ in range(4)]
        digits = rng.integers(0, 256, (4, m), dtype=np.int32)
        on_cpu = M.msm(C.Point(*map(torch.from_numpy, pts)), torch.from_numpy(digits))
        on_card = M.msm(
            C.Point(*(torch.from_numpy(p).to(card) for p in pts)),
            torch.from_numpy(digits).to(card),
        )
        for a, b in zip(on_cpu, on_card):
            assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("n_dev", [4, 3])
def test_sharded_kernel_eq_on_logical_shards_equals_unsharded(card, n_dev):
    """The sharded batch equation (B6) over logical shards of the card
    gives the unsharded kernel_eq's bitmap and eq_ok, on a valid batch and
    on one with a corrupted signature, and its sharded kernel_sig the
    unsharded bitmap; B2 and B3 launch once a shard and once for the
    epilogue."""
    from tendermint_tpu_torch.crypto.cuda import _build
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    privs = [Ed25519PrivKey(bytes([i + 1]) * 32) for i in range(16)]
    items = [(privs[i % 16].pub_key().bytes(), b"shard-%d" % i, privs[i % 16].sign(b"shard-%d" % i))
             for i in range(200)]
    bad = list(items)
    p, m, s = bad[150]
    bad[150] = (p, m, s[:40] + bytes([s[40] ^ 1]) + s[41:])
    devices = [card] * n_dev
    kernel_eq, kernel_sig = V.make_sharded_kernel_eq(devices), V.make_sharded_kernel(devices)
    bucket = V._bucket(256, n_dev)
    for batch in (items, bad):
        entries = [V.resolve_ed25519(*it) for it in batch]
        ops = V._to_device(V.prepare_batch_eq(entries, pad_to=bucket), card)
        for k in _build.KERNELS.values():
            k.launches = 0
        got = kernel_eq(*ops)
        torch.cuda.synchronize()
        launches = {k: _build.KERNELS[k].launches for k in ("fe_pow22523", "scan_blocks")}
        want = V.kernel_eq(*ops)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(got[1]) == (batch is items)
        assert launches == {"fe_pow22523": n_dev + 1, "scan_blocks": n_dev + 1}
        sig_ops = V._to_device(V.prepare_resolved(entries, pad_to=bucket), card)
        assert torch.equal(kernel_sig(*sig_ops), V.kernel_sig(*sig_ops))


def _pairing_inputs(m: int, npairs: int, device, worst: bool):
    """A (m, npairs) pairing bucket: real pairs (item i holds i + 1 pairs,
    the rest pads; in buckets of more than 8 lanes the pairs repeat 8
    prepared ones, item 0 holds 151 at npairs 256 as the aggregate path's
    item does, and the last quarter of the items none), or p - 1 in every
    input with every second lane's lines zero and every third lane a pad
    pair."""
    if not worst and m * npairs <= 8:
        items = [
            [(BM.g1_mul(BM.G1_GEN, 3 + i + j), BM.hash_to_point_g2(b"k7-%d-%d" % (i, j)))
             for j in range(min(i + 1, npairs))]
            for i in range(m)
        ]
        return [torch.from_numpy(a).to(device) for a in BP.prepare_pairing_batch(items, m, npairs)[0]]
    if not worst:
        real = [151 if npairs == 256 and i == 0 else min(i + 1, npairs) for i in range(m)]
        real[m - m // 4:] = [0] * (m // 4)
        return tt.make_pairing_bucket(real, npairs, device)
    pm1 = torch.from_numpy(BF.int_to_limbs(BM.P - 1))
    shapes = [(m, npairs, 49)] * 2 + [(63, m, npairs, 2, 49)] * 4
    out = [pm1.expand(s).clone() for s in shapes]
    lane = torch.arange(m * npairs).reshape(m, npairs)
    for t in out[2:]:
        t[:, lane % 2 == 1] = 0
    out[0][lane % 3 == 2] = 0
    out[1][lane % 3 == 2] = torch.from_numpy(BF.ONE)
    for t in out[2:]:
        t[:, lane % 3 == 2] = 0
    return [t.to(device) for t in out]


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4), (2, 256), (128, 2)])
@pytest.mark.parametrize("worst", [False, True])
def test_bls_miller_kernel_equals_plain(card, shape, worst):
    ins = _pairing_inputs(*shape, card, worst)
    before = BP.MILLER.launches
    got = BP.miller(*ins)
    assert BP.MILLER.launches == before + 1
    assert torch.equal(got, BP._miller_plain(*ins))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (2, 256), (128, 2)])
@pytest.mark.parametrize("worst", [False, True])
def test_bls_final_exp_kernel_equals_plain(card, shape, worst):
    lanes = BP.miller(*_pairing_inputs(*shape, card, worst))
    before = BP.FINAL_EXP.launches
    ok, out = BP.final_exp(lanes)
    assert BP.FINAL_EXP.launches == before + 1
    want_ok, want = BP._final_exp_plain(lanes)
    assert torch.equal(ok, want_ok) and torch.equal(out, want)
    c, f = out[0].cpu().numpy(), lanes[0].cpu().numpy()
    prod = BM.F12_ONE
    for j in range(shape[1]):
        prod = BM.f12_mul(prod, tuple(BF.limbs_to_int(f[j, i, k]) for i in range(6) for k in range(2)))
    assert tuple(BF.limbs_to_int(c[i, k]) for i in range(6) for k in range(2)) == BM.final_exp(prod)


def test_bls_final_exp_kernel_keeps_a_zero_product_zero(card):
    """An item with a zero lane has product zero, and zero's final
    exponentiation is zero (the reference's norm inverse maps 0 to 0);
    beside it lanes of p - 1 and of one."""
    f = torch.from_numpy(BF.int_to_limbs(BM.P - 1)).expand(2, 4, 6, 2, 49).clone()
    f[0, 1] = 0
    f[:, 2] = BF.f12_one()
    f = f.to(card)
    ok, out = BP.final_exp(f)
    want_ok, want = BP._final_exp_plain(f)
    assert torch.equal(ok, want_ok) and torch.equal(out, want)
    assert not bool(ok[0]) and not bool(out[0].any())


def test_bls_kernels_refuse_wrong_operands(card):
    ins = _pairing_inputs(2, 2, card, worst=True)
    with pytest.raises(ValueError):
        BP.miller(ins[0].long(), *ins[1:])
    with pytest.raises(ValueError):
        BP.miller(ins[0], ins[1].cpu(), *ins[2:])
    with pytest.raises(ValueError):
        BP.final_exp(torch.zeros((2, 2, 6, 2, 49), dtype=torch.int64, device=card))


def test_bls_verify_items_on_card_matches_cpu(card):
    sk = [5, 6, 7]
    triples = [(BM.sk_to_pk(k), b"m%d" % k, BM.sign(k, b"m%d" % k)) for k in sk]
    triples[1] = (triples[1][0], b"other", triples[1][2])
    got = BP.verify_items(triples, device=card)
    assert got.tolist() == [True, False, True]
    assert got.tolist() == BP.verify_items(triples, device="cpu").tolist()


# -- B8: SHA-256 -----------------------------------------------------------------

SHA_EDGES = (0, 1, 55, 56, 63, 64, 65, 119, 120, 250, 251, 503)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 255, 256, 257, 4095, 4096, 4097, 16384])
def test_sha256_kernel_equals_plain_and_hashlib(card, n):
    """B8 in one launch, the padding edges mixed in the batch after n % 16
    bytes, against its plain version (torch.equal) and hashlib."""
    import hashlib

    from tendermint_tpu_torch.crypto.cuda import sha256 as S

    lens = SHA_EDGES[n % len(SHA_EDGES):] + SHA_EDGES[: n % len(SHA_EDGES)]
    rng = np.random.default_rng(n)
    msgs = [rng.integers(0, 256, lens[i % len(lens)], dtype=np.uint8).tobytes() for i in range(n)]
    prefix = n % 16
    buf = torch.frombuffer(bytearray(bytes(prefix) + b"".join(msgs)), dtype=torch.uint8).to(card)
    offsets = torch.from_numpy(np.cumsum([prefix] + [len(m) for m in msgs]).astype(np.int64))
    before = S.SHA256.launches
    got = S.sha256_bytes(buf, offsets)
    assert S.SHA256.launches == before + 1
    assert torch.equal(got, S._sha256_bytes_plain(buf, offsets))
    assert [bytes(row) for row in got.cpu().numpy()] == [hashlib.sha256(m).digest() for m in msgs]


def test_sha256_bytes_refuses_a_misaligned_buffer_and_words(card):
    from tendermint_tpu_torch.crypto.cuda import sha256 as S

    buf = torch.zeros(64, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="align it to 16 bytes"):
        S.sha256_bytes(buf[1:], torch.tensor([0, 10], dtype=torch.int64))
    with pytest.raises(ValueError, match="checked on the host"):
        S.sha256_bytes(buf, torch.tensor([0, 10], dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="sha256_bytes"):
        S.sha256_batch(torch.zeros((16, 1, 16), dtype=torch.int32, device=card),
                       torch.zeros(16, dtype=torch.int32, device=card))


def test_sha256_device_on_card_and_its_limit(card):
    import hashlib

    from tendermint_tpu_torch.crypto.cuda import sha256 as S

    msgs = [bytes([i % 256]) * (i % 504) for i in range(4097)]
    assert S.sha256_device(msgs, device=card) == [hashlib.sha256(m).digest() for m in msgs]
    with pytest.raises(ValueError, match="exceeds the device unroll"):
        S.sha256_device([b"x" * 504], device=card)
