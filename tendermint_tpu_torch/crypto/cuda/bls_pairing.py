"""Batched BLS12-381 pairing-product checks on the card — the port of
tendermint_tpu/crypto/tpu/bls_pairing.py (the device graph B7).

One verification ITEM is a pairing-product check prod_i e(P_i, Q_i) == 1:
a single signature is the 2-pair item e(-g1, sig) * e(pk, H(m)), an
aggregate commit one item of n + 1 pairs. The host prepares, per pair,
the G1 point (px, py) and the 63-step Miller line schedule
(`bls_math.prepare_lines`), so the card never touches G2 arithmetic.
Both batch axes are bucket-padded (powers of two; a pad pair has py = 1
and zero lines, so it evaluates to one, and a pad item finishes at one).

The device step is two hand-written kernels (csrc/):

  K7a `miller`     csrc/bls_miller.cu: every lane's 63-step Miller loop
                   and conjugation -> (m, npairs, 6, 2, 49) canonical limbs
  K7b `final_exp`  csrc/bls_final_exp.cu: the pair-axis product, the
                   easy and the hard part, the comparison with one ->
                   (ok (m,), f12 (m, 6, 2, 49) canonical limbs)

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`_miller_plain`, `_final_exp_plain`, on bls_field.py's tower)
for CPU tensors. The boundary tensors keep the reference's layout:
canonical radix-2^8 limbs, int32. Unlike the reference there is no
opt-in switch and no host fallback: the verifier's device decides
(crypto/batch.py).

Both kernels and their plain versions compute the reference's values
by cheaper exact means, so their canonical outputs equal the JAX
graph's limb for limb:
- the Miller loop squares f with a dedicated squaring and multiplies
  by each line as the sparse element it is (bls_field.f12_mul_line); a
  pad lane (py = 1, every line zero: every line is exactly 1) is
  written as one without running the loop;
- the pair product skips lanes whose value is exactly one;
- the hard part of the final exponentiation, f2^d with d = (p^4 - p^2
  + 1) / r, runs on the x-chain d = ((x - 1)^2 / 3)(x + p)(x^2 + p^2 -
  1) + 1 (an identity of integers): exponentiations by k = -(x - 1) / 3
  and by |x|, with Granger-Scott squarings, two Frobenius maps,
  conjugations for the inverses and 52 multiplies (`hard_part`). It is
  valid on the cyclotomic subgroup, where the easy part's output lies
  unless it is zero, and zero stays zero.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve
from ...libs import trace
from .. import bls_math
from . import _build
from . import bls_field as F
from ._build import I32, I64, P

# bit schedule of the Miller loop: 63 steps after |x|'s leading bit;
# 5 of them carry an addition line
X_STEP_BITS = np.array([int(b) for b in bls_math.X_BITS[1:]], dtype=np.int32)
N_STEPS = len(X_STEP_BITS)
# the reference's final-exponentiation hard part, leading bit dropped: the
# work the kernel's bound counts (the kernel runs the x-chain instead)
HARD_STEP_BITS = np.array([int(b) for b in bls_math.HARD_BITS[1:]], dtype=np.int32)
# the x-chain's exponents: |x|, and k = -(x - 1) / 3
X_ABS = -bls_math.X_PARAM
CHAIN_K = (1 - bls_math.X_PARAM) // 3

_MIN_ITEMS = 2
_MAX_ITEMS = 256
_MIN_PAIRS = 2

_PLACE = "tendermint_tpu/crypto/tpu/bls_pairing.py"
MILLER = _build.Kernel(
    "bls_miller", "bls_miller", [P] * 7 + [I64, I32, P],
    replaces=f"{_PLACE}:139 (_build_kernel's Miller scan, :139-147)",
)
FINAL_EXP = _build.Kernel(
    "bls_final_exp", "bls_final_exp", [P] * 3 + [I64, I64, I32, P],
    replaces=f"{_PLACE}:148 (_build_kernel's product tree and final exponentiation, :148-164)",
)

def bucket_items(n: int) -> int:
    """Power-of-two item bucket in [_MIN_ITEMS, _MAX_ITEMS]."""
    b = _MIN_ITEMS
    while b < n and b < _MAX_ITEMS:
        b *= 2
    return b


def bucket_pairs(n: int) -> int:
    b = _MIN_PAIRS
    while b < n:
        b *= 2
    return b


def _check_bucket(m: int, npairs: int) -> None:
    # explicit raise, not `assert`: python -O must not let a non-bucket
    # shape through (the reference guards its compile cache the same way)
    if m != bucket_items(m) or npairs != bucket_pairs(npairs):
        raise ValueError(f"non-bucket pairing shape ({m}, {npairs})")


def hash_to_g2(msgs) -> list:
    """Each message's G2 point (bls_math.hash_to_point_g2, memoized there);
    the host time goes to a `bls.hash_to_curve` trace span."""
    t0 = time.perf_counter()
    pts = [bls_math.hash_to_point_g2(bytes(m)) for m in msgs]
    trace.emit("bls", "hash_to_curve", duration_s=time.perf_counter() - t0, msgs=len(msgs))
    return pts


def prepare_pairing_batch(items: list, pad_to: int = 0, pair_pad: int = 0):
    """Host prep: items is a list of pair-lists [(P, Q), ...] with P a G1
    affine int pair and Q a G2 affine Fq2 pair (both already subgroup
    checked by the caller). Returns the numpy arrays (px, py, dbl_a5,
    dbl_c3, add_a5, add_c3) padded to (pad_to items, pair_pad pairs),
    and the number of real items. The host time goes to two trace spans,
    `bls.prepare_lines` (bls_math.prepare_lines) and `bls.pack` (the
    rest)."""
    n = len(items)
    np_real = max((len(pairs) for pairs in items), default=0)
    m = max(pad_to or 0, n, _MIN_ITEMS)
    npairs = max(pair_pad or 0, np_real, _MIN_PAIRS)
    t_lines = 0.0
    t0 = time.perf_counter()
    px = np.zeros((m, npairs, F.LIMBS), np.int32)
    py = np.zeros((m, npairs, F.LIMBS), np.int32)
    py[:, :, 0] = 1  # pad pairs evaluate every line to exactly 1
    dbl_a5 = np.zeros((N_STEPS, m, npairs, 2, F.LIMBS), np.int32)
    dbl_c3 = np.zeros_like(dbl_a5)
    add_a5 = np.zeros_like(dbl_a5)
    add_c3 = np.zeros_like(dbl_a5)
    for i, pairs in enumerate(items):
        for j, (p, q) in enumerate(pairs):
            px[i, j] = F.int_to_limbs(p[0])
            py[i, j] = F.int_to_limbs(p[1])
            tl = time.perf_counter()
            lines = bls_math.prepare_lines(q)
            t_lines += time.perf_counter() - tl
            idx = 0
            for s, bit in enumerate(X_STEP_BITS):
                for a5_out, c3_out in ((dbl_a5, dbl_c3), (add_a5, add_c3))[: 1 + bit]:
                    a5, c3 = lines[idx]
                    idx += 1
                    a5_out[s, i, j] = F.int_to_limbs(a5[0]), F.int_to_limbs(a5[1])
                    c3_out[s, i, j] = F.int_to_limbs(c3[0]), F.int_to_limbs(c3[1])
            assert idx == len(lines)
    trace.emit("bls", "prepare_lines", duration_s=t_lines, pairs=sum(map(len, items)))
    trace.emit("bls", "pack", duration_s=time.perf_counter() - t0 - t_lines, shape=(m, npairs))
    return (px, py, dbl_a5, dbl_c3, add_a5, add_c3), n


# -- K7a: the Miller loop ----------------------------------------------------


def _line_f12(a5: torch.Tensor, c3: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(..., 2, 49) line coefficients and the (..., 49) evaluation point ->
    the sparse Fq12 py w^0 + c3 w^3 + (a5 px) w^5."""
    w0 = torch.stack([py, torch.zeros_like(py)], -2)
    z = torch.zeros_like(w0)
    return torch.stack([w0, z, z, c3, z, F.fq2_scale(a5, px)], -3)


def pad_lanes(py, dbl_a5, dbl_c3, add_a5, add_c3) -> torch.Tensor:
    """(m, npairs) bool: the lanes whose every line is exactly 1 (py = 1
    and every line the loop reads zero: the doubling lines, and the
    addition lines of the steps whose bit is set), whatever px holds."""
    adds = torch.from_numpy(X_STEP_BITS == 1).to(py.device)
    pad = (py == torch.from_numpy(F.ONE).to(py.device)).all(-1)
    for t in (dbl_a5, dbl_c3, add_a5[adds], add_c3[adds]):
        pad &= (t == 0).all(-1).all(-1).all(0)
    return pad


def _miller_lanes(px, py, dbl_a5, dbl_c3, add_a5, add_c3) -> torch.Tensor:
    """The Miller loop of a (lanes,) batch, before its conjugation: the
    first step's square of one skipped (f starts at the first line), then
    per step the squaring and the sparse line products."""

    def times_line(f, a5, c3):
        return F.f12_mul_line(f, py, c3, F.fq2_scale(a5, px))

    f = _line_f12(dbl_a5[0], dbl_c3[0], px, py)
    for s, bit in enumerate(X_STEP_BITS):
        if s:
            f = times_line(F.f12_sqr(f), dbl_a5[s], dbl_c3[s])
        if bit:
            f = times_line(f, add_a5[s], add_c3[s])
    return f


@torch.inference_mode()
def _miller_plain(px, py, dbl_a5, dbl_c3, add_a5, add_c3) -> torch.Tensor:
    """K7a's plain version: the lanes that are not pads through the Miller
    loop (the addition line multiplied in only on the steps whose bit is
    set: the reference computes both and selects) and its conjugation,
    the pad lanes one; canonical limbs."""
    lines = (dbl_a5, dbl_c3, add_a5, add_c3)
    out = F.f12_one(px.shape[:2], px.device)
    real = (~pad_lanes(py, *lines)).nonzero(as_tuple=True)
    if real[0].numel():
        f = _miller_lanes(px[real], py[real], *(t[:, real[0], real[1]] for t in lines))
        out[real] = F.canonical(F.f12_conj(f))
    return out


def _check_lines(px, py, lines) -> tuple[int, int]:
    m, npairs = px.shape[:2]
    want = (N_STEPS, m, npairs, 2, F.LIMBS)
    for t in (px, py, *lines):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != px.device:
            raise ValueError("pairing operands must be contiguous int32 on one device")
    if tuple(px.shape) != (m, npairs, F.LIMBS) or tuple(py.shape) != tuple(px.shape):
        raise ValueError(f"px/py must be (m, npairs, {F.LIMBS})")
    if any(tuple(t.shape) != want for t in lines):
        raise ValueError(f"line arrays must be {want}")
    return m, npairs


def miller(px, py, dbl_a5, dbl_c3, add_a5, add_c3) -> torch.Tensor:
    """Every lane's conjugated Miller value, canonical (m, npairs, 6, 2,
    49) int32: K7a on the card, its plain version on the CPU."""
    lines = (dbl_a5, dbl_c3, add_a5, add_c3)
    m, npairs = _check_lines(px, py, lines)
    if px.device.type == "cpu":
        return _miller_plain(px, py, *lines)
    out = torch.empty((m, npairs, 6, 2, F.LIMBS), dtype=torch.int32, device=px.device)
    MILLER(
        px.data_ptr(), py.data_ptr(), *(t.data_ptr() for t in lines), out.data_ptr(),
        m * npairs, *_build.stream_args(px),
    )
    return out


# -- K7b: the pair product and the final exponentiation ----------------------


def _cyclotomic_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a in the cyclotomic subgroup (or zero): square-and-multiply
    over e's bits after the leading one, Granger-Scott squarings."""
    acc = a
    for bit in bin(e)[3:]:
        acc = F.f12_cyclotomic_sqr(acc)
        if bit == "1":
            acc = F.f12_mul(acc, a)
    return acc


def hard_part(g: torch.Tensor) -> torch.Tensor:
    """g^((p^4 - p^2 + 1) / r) for g in the cyclotomic subgroup or zero, on
    the x-chain: 314 cyclotomic squarings, 52 multiplies, one p- and one
    p^2-Frobenius (x < 0, and conj is the inverse there)."""
    a = F.f12_conj(_cyclotomic_pow(g, CHAIN_K))  # g^((x - 1) / 3)
    b = F.f12_mul(F.f12_conj(_cyclotomic_pow(a, X_ABS)), F.f12_conj(a))  # a^(x - 1)
    c = F.f12_mul(F.f12_conj(_cyclotomic_pow(b, X_ABS)), F.f12_frob(b))  # b^(x + p)
    e = _cyclotomic_pow(_cyclotomic_pow(c, X_ABS), X_ABS)
    e = F.f12_mul(F.f12_mul(e, F.f12_frob2(c)), F.f12_conj(c))  # c^(x^2 + p^2 - 1)
    return F.f12_mul(e, g)


def _lane_product(f: torch.Tensor) -> torch.Tensor:
    """(m, npairs, 6, 2, 49) canonical lanes -> (m, 6, 2, 49), the product
    over the pair axis of the lanes that are not exactly one (moved to
    the front of each item, a product tree over them, padded with ones to
    a power of two)."""
    one = F.f12_one((), f.device)
    rest = ~(f == one).flatten(2).all(-1)
    order = torch.argsort((~rest).to(torch.int8), dim=1, stable=True)
    width = 1
    while width < int(rest.sum(1).max()):
        width *= 2
    f = torch.take_along_dim(f, order[:, :width, None, None, None], 1)
    if f.shape[1] < width:
        f = torch.cat([f, one.expand(f.shape[0], width - f.shape[1], *one.shape)], 1)
    while f.shape[1] > 1:
        half = f.shape[1] // 2
        f = F.f12_mul(f[:, :half], f[:, half:])
    return f[:, 0]


@torch.inference_mode()
def _final_exp_plain(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7b's plain version: the pair-axis product of the lanes that are not
    one, the reference's easy part, the hard part on the x-chain."""
    f = _lane_product(f)
    f1 = F.f12_mul(F.f12_conj(f), F.f12_inv(f))
    f2 = F.f12_mul(F.f12_frob2(f1), f1)
    acc = hard_part(f2)
    return F.f12_is_one(acc), F.canonical(acc)


def final_exp(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, npairs, 6, 2, 49) canonical lane values -> (ok bool (m,),
    canonical (m, 6, 2, 49) int32): K7b on the card, its plain version on
    the CPU."""
    if f.dtype != torch.int32 or not f.is_contiguous() or f.dim() != 5 \
            or tuple(f.shape[2:]) != (6, 2, F.LIMBS):
        raise ValueError(f"final_exp takes contiguous int32 (m, npairs, 6, 2, {F.LIMBS})")
    if f.device.type == "cpu":
        return _final_exp_plain(f)
    m, npairs = f.shape[:2]
    ok = torch.empty(m, dtype=torch.bool, device=f.device)
    out = torch.empty((m, 6, 2, F.LIMBS), dtype=torch.int32, device=f.device)
    FINAL_EXP(f.data_ptr(), ok.data_ptr(), out.data_ptr(), m, npairs, *_build.stream_args(f))
    return ok, out


# -- the batch API --------------------------------------------------------------


def _run(items: list, pad_to: int, pair_pad: int, device: torch.device):
    """Prepare, copy and run one bucket: (ok (m,), f12 (m, 6, 2, 49), lane
    values (m, npairs, 6, 2, 49), n real items)."""
    arrays, n = prepare_pairing_batch(items, pad_to=pad_to, pair_pad=pair_pad)
    _check_bucket(arrays[0].shape[0], arrays[0].shape[1])
    t0 = time.perf_counter()
    tensors = [torch.from_numpy(a).to(device) for a in arrays]
    trace.emit("bls", "h2d", duration_s=time.perf_counter() - t0)
    lanes = miller(*tensors)
    ok, f12 = final_exp(lanes)
    return ok, f12, lanes, n


def verify_pairs_batch(
    items: list, pad_to: int = 0, pair_pad: int = 0, *, device=DEFAULT_DEVICE
) -> np.ndarray:
    """Run the batched pairing-product check on `device`; returns np.bool_
    (len(items),). Both pads must be bucket shapes (else ValueError)."""
    ok, _f12, _lanes, n = _run(items, pad_to, pair_pad, resolve(device))
    return ok.cpu().numpy()[:n]


def pairing_f12_ints(p, q, *, device=DEFAULT_DEVICE) -> tuple:
    """Single pairing e(P, Q) through the two kernels (or their plain
    versions on the CPU), as bls_math's 12-int tuple."""
    _ok, f12, _lanes, _n = _run([[(p, q)]], _MIN_ITEMS, _MIN_PAIRS, resolve(device))
    c = f12[0].cpu().numpy()
    return tuple(F.limbs_to_int(c[i, j]) for i in range(6) for j in range(2))


def warmup(*, device=DEFAULT_DEVICE, batch: int = _MIN_ITEMS, pairs: int = _MIN_PAIRS) -> None:
    """Build the kernels (first launch) and run one (batch, pairs) bucket."""
    sk = 7
    pk = bls_math.sk_to_pk(sk)
    sig = bls_math.sign(sk, b"bls-warmup")
    h = bls_math.hash_to_point_g2(b"bls-warmup")
    item = [(bls_math.NEG_G1_GEN, sig), (pk, h)]
    verify_pairs_batch(
        [item] * batch, pad_to=bucket_items(batch), pair_pad=bucket_pairs(pairs), device=device
    )


def verify_items(triples: list, *, device=DEFAULT_DEVICE) -> np.ndarray:
    """Batched single-signature verification: triples are (pubkey point,
    msg bytes, sig point), points subgroup-checked; each is the 2-pair item
    e(-g1, sig) * e(pk, H(m)). Batches larger than the top item bucket run
    in _MAX_ITEMS chunks."""
    dev = resolve(device)
    hashes = hash_to_g2([msg for _pk, msg, _sig in triples])
    items = [
        [(bls_math.NEG_G1_GEN, sig), (pk, h)] for (pk, _msg, sig), h in zip(triples, hashes)
    ]
    outs = []
    for i in range(0, len(items), _MAX_ITEMS):
        chunk = items[i : i + _MAX_ITEMS]
        outs.append(
            verify_pairs_batch(
                chunk, pad_to=bucket_items(len(chunk)), pair_pad=_MIN_PAIRS, device=dev
            )
        )
    return np.concatenate(outs) if outs else np.zeros(0, dtype=bool)
