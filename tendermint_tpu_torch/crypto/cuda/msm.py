"""Multi-scalar multiplication (MSM) on the ed25519 curve, batched.

The port of tendermint_tpu/crypto/tpu/msm.py: the compute core of
randomized linear-combination batch verification. Pippenger's bucket
method with radix-256 windows (digits are the little-endian bytes of the
scalars):

  MSM = Σ_i d_i·P_i = Σ_w 256^w · W_w,   W_w = Σ_j j·B_{w,j}

with B_{w,j} the sum of the points whose window-w digit is j. Per window
the points are sorted by digit and prefix-summed; writing C_j for the
prefix at the last point with digit ≤ j, the weighted bucket sum
telescopes to

  W_w = Σ_{j≥1} j·(C_j − C_{j−1}) = 255·C_255 − Σ_{k=0}^{254} C_k

Where the reference vmaps `_window_sum` over windows, every function here
carries the window axis as a leading dimension W: points are (M, 32)
limbs shared by all windows, digits are (W, M), and sorted points,
prefixes and window sums are (W, ..., 32).

Kernel in this module (CUDA C++, csrc/scan_blocks.cu):

  B3 `scan_blocks` replaces pallas_field._scan_blocks_limbs_first: the
  within-block inclusive prefix sums of `_boundary_prefixes`, 15 cached
  additions (120 field multiplies) per 16-point block. It runs on the
  shuffle-free multiply of csrc/fe25519_group.cuh. Each of a step's two
  rounds holds four independent multiplies, so sixteen lanes own one
  chain, as four groups of four, each group one multiply and one add or
  sub per round, meeting through shared memory; a warp walks two chains,
  and the next step's cached operands are copied into shared memory
  (cp.async) while the current one computes. On an H100 it sits at the
  ridge between bytes and operations: a chain moves 16 KB (its first
  point and 15 cached operands in, its 16 prefixes out) for ~316k
  operations, ~19 per byte. Its arithmetic is the plain version's,
  limb for limb: `sub` adds the reference's EIGHT_P (zero), as the
  reference's lax.scan does, not the Pallas kernel's true 8p. Unlike the
  TPU wrapper it needs no tile-multiple gate: the kernel masks its own
  ragged edge, so every blocked-path call on a CUDA tensor goes through
  it, the A-side MSM's small windows included.
"""

from __future__ import annotations

import torch

from . import _build
from . import curve
from . import field as F
from .curve import CachedPoint, Point

WINDOW_BITS = 8
N_BUCKETS = 256
_BLOCK = 16  # sequential within-block scan length (see _boundary_prefixes)


# -- B3: within-block prefix scan -------------------------------------------------

SCAN_BLOCKS = _build.Kernel(
    "scan_blocks",
    "scan_blocks",
    [_build.P] * 12 + [_build.I64, _build.I32, _build.I32, _build.P],
    replaces="tendermint_tpu/crypto/tpu/pallas_field.py:222",
)


def scan_blocks(first: Point, rest: CachedPoint) -> Point:
    """Inclusive prefix sums along chains of cached additions.

    first: 4 × (C, 32) — each chain's first point; rest: 4 × (S, C, 32) —
    the cached operands of steps 1..S. Returns 4 × (C, S+1, 32), prefix 0
    being the first point (the reference's `scan_blocks` layout)."""
    if F.on_card(first.x):
        return _scan_blocks_cuda(first, rest)
    return _scan_blocks_plain(first, rest)


def _scan_blocks_cuda(first: Point, rest: CachedPoint) -> Point:
    ins, chains, steps = _scan_operands(first, rest)
    outs = [
        torch.empty((chains, steps + 1, F.LIMBS), dtype=torch.int32, device=first.x.device)
        for _ in range(4)
    ]
    if chains:
        SCAN_BLOCKS(
            *(t.data_ptr() for t in ins + outs),
            chains,
            steps,
            *_build.stream_args(first.x),
        )
    return Point(*outs)


def _scan_operands(first: Point, rest: CachedPoint) -> tuple[list[torch.Tensor], int, int]:
    """B3's eight inputs as its kernel reads them (16-byte copies): each
    the tensor itself when it is contiguous and 16-byte aligned, else a
    contiguous copy. Raises unless all eight are int32 limbs on one
    device, `first` (C, 32) and `rest` (S, C, 32). Returns (inputs, C, S)."""
    for t in (*first, *rest):
        F._check(t)
    chains, steps = first.x.shape[0], rest.ymx.shape[0]
    if any(t.shape != (chains, F.LIMBS) for t in first) or any(
        t.shape != (steps, chains, F.LIMBS) for t in rest
    ):
        raise ValueError(
            "scan_blocks wants 4 x (C, 32) first points and 4 x (S, C, 32) cached "
            f"operands, got {[tuple(t.shape) for t in (*first, *rest)]}"
        )
    if any(t.device != first.x.device for t in (*first, *rest)):
        raise ValueError(f"scan_blocks operands on {[str(t.device) for t in (*first, *rest)]}")
    return [F._operand(t, t.shape)[0] for t in (*first, *rest)], chains, steps


def _scan_blocks_plain(first: Point, rest: CachedPoint) -> Point:
    """B3's plain version: a Python loop of `add_cached` on `_mul_plain`
    arithmetic (the reference's lax.scan, msm.py:148-160)."""
    acc = first
    prefixes = [first]
    for j in range(rest.ymx.shape[0]):
        acc = _add_cached_plain(acc, CachedPoint(*(c[j] for c in rest)))
        prefixes.append(acc)
    return Point(*(torch.stack(cs, dim=1) for cs in zip(*prefixes)))


def _add_cached_plain(p: Point, q: CachedPoint) -> Point:
    """curve.add_cached with every multiply on `_mul_plain`."""
    mul = F._mul_plain
    a = mul(F.sub(p.y, p.x), q.ymx)
    b = mul(F.add(p.y, p.x), q.ypx)
    c = mul(p.t, q.t2d)
    d = mul(p.z, q.z2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return Point(mul(e, f), mul(g, h), mul(f, g), mul(e, h))


# -- point reductions ---------------------------------------------------------------


def _take(p: Point, idx: torch.Tensor, dim: int) -> Point:
    """Gather along `dim` with `idx` shaped like the leading dims up to
    and including `dim` (batched over the dims before it)."""
    idx = idx.unsqueeze(-1).expand(idx.shape + (F.LIMBS,))
    return Point(*(torch.gather(c, dim, idx) for c in p))


def _inclusive_scan(p: Point, dim: int) -> Point:
    """Inclusive prefix sums of point additions along `dim` (log-depth
    Hillis–Steele). Stands in for jax.lax.associative_scan: the group sum
    is the same, the association order (hence the limbs) may differ."""
    n = p.x.shape[dim]
    off = 1
    while off < n:
        lo = Point(*(c.narrow(dim, 0, n - off) for c in p))
        hi = Point(*(c.narrow(dim, off, n - off) for c in p))
        summed = curve.point_add(lo, hi)
        p = Point(
            *(torch.cat([c.narrow(dim, 0, off), s], dim) for c, s in zip(p, summed))
        )
        off *= 2
    return p


def _tree_reduce_points(p: Point, dim: int) -> Point:
    """Pairwise tree reduction with point_add along `dim` (length must be
    a power of two)."""
    n = p.x.shape[dim]
    if n & (n - 1):
        raise ValueError("tree reduce needs a power-of-two length")
    while n > 1:
        half = n // 2
        lo = Point(*(c.narrow(dim, 0, half) for c in p))
        hi = Point(*(c.narrow(dim, half, half) for c in p))
        p = curve.point_add(lo, hi)
        n = half
    return Point(*(c.squeeze(dim) for c in p))


def _mul_255(p: Point) -> Point:
    """255·P via r ← 2r + P seven times (255 = 2^8 − 1)."""
    cached = curve.to_cached(p)
    r = p
    for _ in range(7):
        r = curve.add_cached(curve.point_double(r), cached)
    return r


def _boundary_prefixes(sorted_pts: Point, counts: torch.Tensor) -> Point:
    """C_j = sum of the first counts[w, j] sorted points of window w
    (identity when counts[w, j] == 0), for the 256 bucket boundaries.

    sorted_pts: 4 × (W, M, 32); counts: (W, 256). Returns 4 × (W, 256, 32).

    Blocked scheme (~M + 2·M/16 + 256 adds per window): 16-point blocks,
    within-block inclusive prefixes (B3), an inclusive scan over the block
    totals shifted into exclusive offsets, and one add per boundary.
    Falls back to a scan over all M points when M is not a multiple of 16
    or gives fewer than two blocks."""
    w, m = sorted_pts.x.shape[:2]
    dev = sorted_pts.x.device
    ident = curve.identity((w, 1), dev)
    if m % _BLOCK or m // _BLOCK < 2:
        prefix = _inclusive_scan(sorted_pts, dim=1)
        padded = Point(*(torch.cat([i_c, c], dim=1) for i_c, c in zip(ident, prefix)))
        return _take(padded, counts, dim=1)

    g = m // _BLOCK
    blocks = Point(*(c.reshape(w * g, _BLOCK, F.LIMBS) for c in sorted_pts))
    first = Point(*(c[:, 0] for c in blocks))  # (W·g, 32)
    rest = curve.to_cached(
        Point(*(c[:, 1:].transpose(0, 1) for c in blocks))
    )  # (15, W·g, 32)
    prefixes = scan_blocks(first, rest)  # (W·g, 16, 32)
    within = Point(*(c.reshape(w, m, F.LIMBS) for c in prefixes))
    last = Point(*(c[:, -1].reshape(w, g, F.LIMBS) for c in prefixes))  # block totals

    # exclusive block offsets: shift the inclusive totals scan right
    totals_prefix = _inclusive_scan(last, dim=1)
    offsets = Point(
        *(torch.cat([i_c, c[:, :-1]], dim=1) for i_c, c in zip(ident, totals_prefix))
    )  # (W, g, 32): sum of all blocks before this one

    # boundary p = counts[j]-1: C_j = offsets[p // 16] + within[p]
    p = (counts - 1).clamp(min=0)
    c_pts = curve.point_add(_take(offsets, p // _BLOCK, dim=1), _take(within, p, dim=1))
    return curve.point_select(counts != 0, c_pts, curve.identity(counts.shape, dev))


def _window_sum(points: Point, digits: torch.Tensor) -> Point:
    """Σ_j j·B_j for every window. points: 4 × (M, 32); digits: (W, M).
    Returns 4 × (W, 32)."""
    w = digits.shape[0]
    # stable, like jnp.argsort: equal digits keep their input order
    order = torch.argsort(digits, dim=-1, stable=True)  # (W, M)
    sorted_digits = torch.gather(digits, -1, order)
    sorted_pts = Point(*(c[order] for c in points))  # (W, M, 32)

    # counts c_j = #digits ≤ j: C_j sits at the last position with digit ≤ j
    buckets = torch.arange(N_BUCKETS, dtype=digits.dtype, device=digits.device)
    counts = torch.searchsorted(
        sorted_digits.contiguous(), buckets.expand(w, N_BUCKETS).contiguous(), right=True
    )
    C = _boundary_prefixes(sorted_pts, counts)  # (W, 256, 32)

    c255 = Point(*(c[:, N_BUCKETS - 1] for c in C))
    # Σ_{k=0..254} C_k: overwrite slot 255 with the identity, reduce all 256
    ident = curve.identity((w, 1), digits.device)
    partial = Point(
        *(torch.cat([c[:, : N_BUCKETS - 1], i_c], dim=1) for c, i_c in zip(C, ident))
    )
    sum_c = _tree_reduce_points(partial, dim=1)
    return curve.point_add(_mul_255(c255), curve.point_neg(sum_c))


def msm(points: Point, digit_rows: torch.Tensor) -> Point:
    """Multi-scalar multiplication Σ_i scalar_i · P_i.

    points: extended coords, each (M, 32) int32 limbs.
    digit_rows: (W, M) — radix-256 little-endian digits of the scalars,
    window w of point i at digit_rows[w, i]. Returns one Point with
    coordinates of shape (32,)."""
    window_sums = _window_sum(points, digit_rows)
    # Horner over windows, most significant first: acc ← 256·acc + W_w
    n_win = digit_rows.shape[0]
    acc = Point(*(c[n_win - 1] for c in window_sums))
    for wi in range(n_win - 2, -1, -1):
        for _ in range(WINDOW_BITS):
            acc = curve.point_double(acc)
        acc = curve.point_add(acc, Point(*(c[wi] for c in window_sums)))
    return acc

