"""Batched ed25519 and sr25519 verification on the card: host
preparation, the device steps `kernel_eq` and `kernel_sig`, chunked
dispatch, and the `BatchVerifier` that crypto/batch.py hands out.

The port of tendermint_tpu/crypto/tpu/verify.py. Pipeline:

  host:   parse signatures, range-check s < L, derive the challenge
          k = SHA-512(R ‖ A ‖ msg) mod L (ed25519) or the Merlin
          transcript challenge of a ristretto-decoded sr25519 signature,
          draw the random coefficients zᵢ, group them by public key
  device: `kernel_eq` — decompress keys and R points, two MSMs, the
          cofactored identity check of the batch equation
  host:   the per-signature bitmap; when the equation fails, `kernel_sig`
          (one double-scalar multiplication per signature) attributes it

Batches are padded to power-of-two buckets (floor 64): that keeps the
MSM on its blocked path (kernel B3) and the window sums on a 16-aligned
length. There is no probe choosing between a kernel and an XLA graph, as
the reference's `_maybe_enable_pallas` does: on the card the kernels are
the path, and an error is raised, not routed around.

Sharding (the reference's `make_sharded_kernel_eq` / `make_sharded_kernel`,
B6): when the mesh (crypto/cuda/mesh.py) holds more than one device of
the caller's type and a chunk fills a floor bucket on every one of them,
the chunk is padded to a bucket divisible by the mesh size and split into
contiguous shards. Shard k goes to the mesh's device k, which decompresses
its R points and reduces its R-side MSM to one partial point; the partials
and the R masks are gathered to the first device, folded
(`_reduce_partials`), and the epilogue — the unique keys, the grouped
A-side MSM with zs·B, the identity check — runs there once. Every shard's
work is issued before anything is read back. The devices may repeat:
`[cuda:0] * 4` runs four logical shards on one card, one after another on
its stream. There is no breaker and no degrade to a smaller mesh: a shard
that fails makes the dispatch raise.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Callable

import numpy as np
import torch

from .. import BatchVerifier, PubKey
from ...device import DEFAULT_DEVICE
from ...device import resolve as resolve_device
from . import curve, mesh, msm
from .curve import Point

L = 2**252 + 27742317777372353535851937790883648493

_MIN_BUCKET = 64
#: Largest single-launch batch: bigger ranges split into chunks of this
#: size, all issued before any result is read back. TMTPU_MAX_BUCKET sets
#: it, as in the reference (read once, at import).
_MAX_BUCKET = int(os.environ.get("TMTPU_MAX_BUCKET", "8192"))

RandBytes = Callable[[int], bytes]


def kernel_sig(a_bytes, r_bytes, s_digits, h_digits, s_valid) -> torch.Tensor:
    """Per-signature verification (the reference's `_kernel`). All inputs
    on one device: a_bytes/r_bytes (B,32), s_digits/h_digits (B,64)
    radix-16 little-endian digits, s_valid (B,) bool. A and R are
    decompressed in one stacked call. Returns the (B,) bool bitmap."""
    a_bytes, r_bytes = a_bytes.to(torch.int32), r_bytes.to(torch.int32)
    stacked, ok = curve.decompress(torch.cat([a_bytes, r_bytes], dim=0))
    n = a_bytes.shape[0]
    A = Point(*(c[:n] for c in stacked))
    R = Point(*(c[n:] for c in stacked))
    v = curve.scalar_mul_double(s_digits, h_digits, curve.point_neg(A))  # sB - kA
    w = curve.point_add(v, curve.point_neg(R))  # sB - kA - R
    eq_ok = curve.is_identity(curve.mul_by_cofactor(w))
    return ok[:n] & ok[n:] & eq_ok & s_valid


def kernel_eq(ua_bytes, r_bytes, ga_digits, r_digits, zs_digits, s_valid, gidx):
    """Randomized linear-combination batch verification (the reference's
    `_kernel_eq`): ONE multi-scalar multiplication

        [8]( zs·B − Σ_g c_g·A_g − Σ zᵢ·Rᵢ ) == O

    with zs = Σ zᵢ·sᵢ mod L and c_g = Σ_{i: Aᵢ=A_g} zᵢkᵢ mod L over the G
    unique keys (A-side grouping). The final ×8 kills every torsion
    component, so reducing the scalars mod L is exact.

    Inputs (one device): ua_bytes (G,32) unique compressed keys; r_bytes
    (N,32); ga_digits (32,G) radix-256 digits of c_g; r_digits (16,N)
    digits of zᵢ; zs_digits (32,1); s_valid (N,) bool; gidx (N,) mapping
    each signature to its key group. Format-invalid entries arrive with
    zeroed digits and decompression failures are masked to the identity,
    so neither perturbs the sum. Returns (ok_bitmap (N,), eq_ok ()): on
    eq_ok the bitmap IS the per-signature answer."""
    ua_bytes, r_bytes, r_digits = (x.to(torch.int32) for x in (ua_bytes, r_bytes, r_digits))
    dev = r_bytes.device
    g, n = ua_bytes.shape[0], r_bytes.shape[0]
    stacked, ok = curve.decompress(torch.cat([ua_bytes, r_bytes], dim=0))
    A = Point(*(c[:g] for c in stacked))
    R = Point(*(c[g:] for c in stacked))
    a_ok, r_ok = ok[:g], ok[g:]
    r_use = r_ok & s_valid
    ok_bitmap = a_ok[gidx.long()] & r_use
    Rm = curve.point_select(r_use, curve.point_neg(R), curve.identity((n,), dev))
    acc = curve.point_add(_a_side_msm(A, a_ok, ga_digits, zs_digits), msm.msm(Rm, r_digits))
    eq_ok = curve.is_identity(curve.mul_by_cofactor(acc))
    return ok_bitmap, eq_ok


def _a_side_msm(A: Point, a_ok, ga_digits, zs_digits) -> Point:
    """Σ_g c_g·(−A_g) + zs·B: the grouped A-side MSM, the keys that did
    not decompress masked to the identity, the base point carried as one
    extra row with scalar zs."""
    dev = A.x.device
    Am = curve.point_select(a_ok, curve.point_neg(A), curve.identity((A.x.shape[0],), dev))
    bpt = curve.base_point((1,), dev)
    ga = Point(*(torch.cat([c, b], dim=0) for c, b in zip(Am, bpt)))
    digits = torch.cat([ga_digits, zs_digits], dim=1).to(torch.int32)
    return msm.msm(ga, digits)


# -- B6: the batch equation and the per-signature kernel over a mesh ----------------


def _local_partial(r_bytes, r_digits, s_valid) -> tuple[torch.Tensor, Point]:
    """One shard's share of the batch equation (the reference's
    `local_partial`): decompress its R points, mask the unusable ones to
    the identity, and reduce its R-side MSM Σ zᵢ·(−Rᵢ) to one partial
    point. A shard whose length is not a multiple of 16 (a mesh of three:
    8,193 rows in shards of 2,731) is padded with identity rows of digit
    0 after the decompression, which adds nothing to the sum and keeps
    its MSM on the blocked path (B3) where the reference's falls back to
    a scan over all points. Returns (r_use (n,), partial 4 × (32,))."""
    r_bytes, r_digits = r_bytes.to(torch.int32), r_digits.to(torch.int32)
    dev, n = r_bytes.device, r_bytes.shape[0]
    R, r_ok = curve.decompress(r_bytes)
    r_use = r_ok & s_valid
    Rm = curve.point_select(r_use, curve.point_neg(R), curve.identity((n,), dev))
    pad = -n % msm._BLOCK
    if pad:
        Rm = Point(*(torch.cat([c, i]) for c, i in zip(Rm, curve.identity((pad,), dev))))
        r_digits = torch.cat([r_digits, r_digits.new_zeros((r_digits.shape[0], pad))], dim=1)
    return r_use, msm.msm(Rm, r_digits)


def _reduce_partials(partials: Point) -> Point:
    """Fold the shards' partial points, 4 × (n_dev, 32), into one: a
    pairwise tree on a power-of-two mesh, a chain of point_add in shard
    order (0, 1, …, n_dev − 1) otherwise, as the reference folds them."""
    n_dev = partials.x.shape[0]
    if n_dev & (n_dev - 1) == 0:
        return msm._tree_reduce_points(partials, dim=0)
    total = Point(*(c[0] for c in partials))
    for k in range(1, n_dev):
        total = curve.point_add(total, Point(*(c[k] for c in partials)))
    return total


def _shard_bounds(rows: int, n_dev: int) -> list[tuple[int, int]]:
    if rows % n_dev:
        raise ValueError(f"{rows} signatures do not split into {n_dev} equal shards")
    s = rows // n_dev
    return [(k * s, (k + 1) * s) for k in range(n_dev)]


def make_sharded_kernel_eq(devices) -> Callable:
    """`kernel_eq` over a mesh of `devices` (the reference's
    `make_sharded_kernel_eq`; torch devices in place of a Mesh, repeats
    allowed). Takes `kernel_eq`'s operands on any device, with the
    signature axis divisible by the mesh size; shard k of r_bytes,
    s_valid (rows) and r_digits (columns) goes to devices[k]. The partial
    points and R masks are gathered to devices[0], where the fold and the
    epilogue run once and the result lies."""
    devices = [torch.device(d) for d in devices]
    home = devices[0]

    def kernel(ua_bytes, r_bytes, ga_digits, r_digits, zs_digits, s_valid, gidx):
        shards = [
            _local_partial(r_bytes[lo:hi].to(dev), r_digits[:, lo:hi].to(dev), s_valid[lo:hi].to(dev))
            for dev, (lo, hi) in zip(devices, _shard_bounds(r_bytes.shape[0], len(devices)))
        ]
        # the gather: one partial point and one mask per shard
        r_use = torch.cat([use.to(home) for use, _ in shards])
        partials = Point(*(torch.stack([part[c].to(home) for _, part in shards]) for c in range(4)))
        total = _reduce_partials(partials)
        A, a_ok = curve.decompress(ua_bytes.to(home, torch.int32))
        acc = curve.point_add(total, _a_side_msm(A, a_ok, ga_digits.to(home), zs_digits.to(home)))
        ok_bitmap = a_ok[gidx.to(home).long()] & r_use
        return ok_bitmap, curve.is_identity(curve.mul_by_cofactor(acc))

    return kernel


def make_sharded_kernel(devices) -> Callable:
    """`kernel_sig` with the batch axis sharded over `devices` (the
    reference's `make_sharded_kernel`): shard k of every operand runs
    `kernel_sig` on devices[k]; the bitmaps are gathered to devices[0]."""
    devices = [torch.device(d) for d in devices]
    home = devices[0]

    def kernel(*ops):
        outs = [
            kernel_sig(*(x[lo:hi].to(dev) for x in ops))
            for dev, (lo, hi) in zip(devices, _shard_bounds(ops[0].shape[0], len(devices)))
        ]
        return torch.cat([o.to(home) for o in outs])

    return kernel


class ResolvedSig:
    """A signature reduced to the Edwards-form check [8](s·B − k·A − R) == O,
    the shape both key types share. ed25519: k = SHA-512(R ‖ A ‖ msg) mod
    L; sr25519: k is the Merlin transcript challenge and A/R are the
    ristretto coset representatives re-encoded in ed25519 compressed
    form."""

    __slots__ = ("a", "r", "s", "k")

    def __init__(self, a: bytes, r: bytes, s: int, k: int):
        self.a = a
        self.r = r
        self.s = s
        self.k = k


def resolve_ed25519(pub: bytes, msg: bytes, sig: bytes) -> ResolvedSig | None:
    """None = malformed (wrong sizes or non-canonical s ≥ L)."""
    if len(pub) != 32 or len(sig) != 64:
        return None
    r, s = sig[:32], sig[32:]
    s_int = int.from_bytes(s, "little")
    if s_int >= L:
        return None
    k = int.from_bytes(hashlib.sha512(r + pub + msg).digest(), "little") % L
    return ResolvedSig(pub, r, s_int, k)


def resolve_sr25519(pub: bytes, msg: bytes, sig: bytes) -> ResolvedSig | None:
    """None = malformed (wrong sizes, no schnorrkel marker, an invalid
    ristretto encoding, or s ≥ L once the marker bit is cleared)."""
    from .. import sr25519

    triple = sr25519.to_edwards_triple(pub, msg, sig)
    if triple is None:
        return None
    a_ed, r_ed, k = triple
    s_clear = bytearray(sig[32:])
    s_clear[31] &= 0x7F
    s_int = int.from_bytes(bytes(s_clear), "little")
    if s_int >= L:
        return None
    return ResolvedSig(a_ed, r_ed, s_int, k)


def resolve(pub_key: PubKey, msg: bytes, sig: bytes) -> ResolvedSig | None:
    """Dispatch on the key's TYPE; None for a type the equation does not
    take."""
    if pub_key.TYPE == "ed25519":
        return resolve_ed25519(pub_key.bytes(), msg, sig)
    if pub_key.TYPE == "sr25519":
        return resolve_sr25519(pub_key.bytes(), msg, sig)
    return None


def prepare_resolved(entries: list[ResolvedSig | None], pad_to: int = 0):
    """ResolvedSig list -> `kernel_sig` inputs as numpy arrays (a_bytes,
    r_bytes, s_digits, h_digits, s_valid); None entries and padding rows
    stay invalid."""
    n = len(entries)
    m = max(pad_to, n)
    a_np = np.zeros((m, 32), np.uint8)
    r_np = np.zeros((m, 32), np.uint8)
    s_np = np.zeros((m, 32), np.uint8)
    h_np = np.zeros((m, 32), np.uint8)
    s_valid = np.zeros(m, bool)
    for i, e in enumerate(entries):
        if e is None:
            continue
        s_valid[i] = True
        a_np[i] = np.frombuffer(e.a, np.uint8)
        r_np[i] = np.frombuffer(e.r, np.uint8)
        s_np[i] = np.frombuffer(e.s.to_bytes(32, "little"), np.uint8)
        h_np[i] = np.frombuffer(e.k.to_bytes(32, "little"), np.uint8)

    def to_digits(b: np.ndarray) -> np.ndarray:
        """(N,32) bytes -> (N,64) radix-16 little-endian digits."""
        d = np.empty((b.shape[0], 64), np.int32)
        d[:, 0::2] = b & 0xF
        d[:, 1::2] = b >> 4
        return d

    return (
        a_np.astype(np.int32),
        r_np.astype(np.int32),
        to_digits(s_np),
        to_digits(h_np),
        s_valid,
    )


def _group_bucket(g: int) -> int:
    """Pad the unique-key count so the A-side MSM length (G + 1 base-point
    row) lands on a power of two ≥ 64: the blocked prefix scan needs a
    multiple of 16."""
    b = _MIN_BUCKET
    while b < g + 1:
        b *= 2
    return b - 1


def prepare_batch_eq(
    entries: list[ResolvedSig | None],
    pad_to: int = 0,
    rand_bytes: RandBytes | None = None,
):
    """Host prep for `kernel_eq`. pad_to ≥ len(entries) pads the signature
    axis with inert rows; the unique-key axis is padded to a group bucket.
    The 128-bit coefficients come from `rand_bytes(16·n)` — os.urandom
    (cryptographic) unless the caller passes its own. Returns (ua_bytes,
    r_bytes, ga_digits, r_digits, zs_digits, s_valid, gidx) numpy arrays."""
    n = len(entries)
    m = max(pad_to, n)
    r_np = np.zeros((m, 32), np.uint8)
    r_sc = np.zeros((m, 16), np.uint8)  # z bytes
    s_valid = np.zeros(m, bool)
    gidx = np.zeros(m, np.int32)
    group_of: dict[bytes, int] = {}
    ua: list[bytes] = []
    coeffs: list[int] = []  # per-group Σ z·k, reduced once at the end
    zs = 0
    rnd = (rand_bytes or os.urandom)(16 * n)
    for i, e in enumerate(entries):
        if e is None:
            continue
        gi = group_of.get(e.a)
        if gi is None:
            gi = group_of[e.a] = len(ua)
            ua.append(e.a)
            coeffs.append(0)
        gidx[i] = gi
        s_valid[i] = True
        r_np[i] = np.frombuffer(e.r, np.uint8)
        # z ∈ [1, 2^128): |1 excludes zero, which would drop the signature
        z = int.from_bytes(rnd[16 * i : 16 * i + 16], "little") | 1
        r_sc[i] = np.frombuffer(z.to_bytes(16, "little"), np.uint8)
        coeffs[gi] += z * e.k
        zs += z * e.s
    gb = _group_bucket(len(ua))
    ua_np = np.zeros((gb, 32), np.uint8)
    ga_sc = np.zeros((gb, 32), np.uint8)
    for gi, (key, c) in enumerate(zip(ua, coeffs)):
        ua_np[gi] = np.frombuffer(key, np.uint8)
        ga_sc[gi] = np.frombuffer((c % L).to_bytes(32, "little"), np.uint8)
    zs_digits = np.frombuffer((zs % L).to_bytes(32, "little"), np.uint8).reshape(32, 1)
    return (
        ua_np,
        r_np,
        np.ascontiguousarray(ga_sc.T),  # (32, gb)
        np.ascontiguousarray(r_sc.T),  # (16, m)
        zs_digits,
        s_valid,
        gidx,
    )


def _bucket(n: int, multiple: int = 1) -> int:
    """The padded size of an n-signature chunk: a power of two ≥ 64,
    rounded up to `multiple` (the mesh size on a sharded dispatch)."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    if b % multiple:
        b = ((b + multiple - 1) // multiple) * multiple
    return b


def _is_warm_bucket(m: int, multiple: int = 1) -> bool:
    """True when `m` is a shape the bucket ladder can produce: some power
    of two ≥ _MIN_BUCKET rounded up to `multiple`."""
    if m < _MIN_BUCKET:
        return False
    multiple = max(1, multiple)
    b = _MIN_BUCKET
    while True:
        rounded = ((b + multiple - 1) // multiple) * multiple
        if rounded == m:
            return True
        if rounded > m:
            return False
        b *= 2


def _to_device(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


def _shard_devices(device: torch.device) -> list[torch.device]:
    """The devices a sharded dispatch from `device` may span now: the
    mesh when it holds more than one device of `device`'s type, else [].
    TMTPU_MESH_MAX_DEVICES caps the mesh inside the registry (1 pins one
    device)."""
    devs = mesh.devices_for(device)
    return devs if len(devs) > 1 else []


def _shard_device_count(device: torch.device) -> int:
    """The mesh size a dispatch from `device` shards over (1: one device)."""
    return max(1, len(_shard_devices(device)))


#: device tuple -> (sharded kernel_eq, sharded kernel_sig), keyed by the
#: exact list of devices, repeats included
_sharded_kernels: dict[tuple, tuple[Callable, Callable]] = {}


def _get_sharded(devices: list[torch.device]) -> tuple[Callable, Callable]:
    key = tuple(str(d) for d in devices)
    kernels = _sharded_kernels.get(key)
    if kernels is None:
        kernels = _sharded_kernels[key] = (
            make_sharded_kernel_eq(devices), make_sharded_kernel(devices)
        )
    return kernels


class _Selection:
    """One dispatch plan: the kernels, the padded bucket, and the mesh
    (None on one device)."""

    __slots__ = ("kernel_eq", "kernel_sig", "bucket", "devices")

    def __init__(self, kernel_eq, kernel_sig, bucket, devices):
        self.kernel_eq = kernel_eq
        self.kernel_sig = kernel_sig
        self.bucket = bucket
        self.devices = devices

    @property
    def n_dev(self) -> int:
        return len(self.devices) if self.devices else 1


def _select_kernels(n: int, device: torch.device) -> _Selection:
    """The plan for an n-signature chunk from `device`: sharded over the
    mesh when every shard still fills a floor bucket (or
    TMTPU_FORCE_SHARDED=1), with the bucket rounded up to a multiple of
    the mesh size; on `device` alone otherwise."""
    devices = _shard_devices(device)
    n_dev = len(devices)
    if n_dev > 1 and (os.environ.get("TMTPU_FORCE_SHARDED") == "1" or n >= _MIN_BUCKET * n_dev):
        kernel_eq_sharded, kernel_sig_sharded = _get_sharded(devices)
        return _Selection(kernel_eq_sharded, kernel_sig_sharded, _bucket(n, n_dev), devices)
    return _Selection(kernel_eq, kernel_sig, _bucket(n), None)


def _shard_fill(n_real: int, bucket: int, n_dev: int) -> list[int]:
    """Real (non-padding) signatures on each contiguous shard of a
    `bucket`-row chunk."""
    s = bucket // n_dev
    return [max(0, min(s, n_real - k * s)) for k in range(n_dev)]


#: this thread's last sharded dispatch (the hub's dispatch spans read it):
#: thread-local, so concurrent verifiers do not misattribute each other
_dispatch_local = threading.local()


def last_dispatch_info() -> dict | None:
    """{"devices": [...], "shards": [...]}: the device id and the real
    signatures of each shard of this thread's last dispatch, summed over
    its chunks; None when it ran on one device."""
    return getattr(_dispatch_local, "info", None)


def _dispatch_and_collect(
    n: int,
    get_entries: Callable[[int, int], list],
    device: torch.device,
    rand_bytes: RandBytes | None,
) -> np.ndarray:
    """Chunked dispatch: get_entries(i, j) resolves one chunk's entries as
    the loop runs, so chunk k+1's host work (SHA-512, bigint prep)
    overlaps chunk k's device work — launches return before the card
    finishes, and no result is read back until every chunk is issued.
    Every chunk of a multi-chunk batch shares the full chunk's bucket and
    plan (`_select_kernels`). A chunk whose equation fails is attributed
    by the plan's `kernel_sig`, that chunk alone. An error, on one device
    or in any shard, raises."""
    _dispatch_local.info = None
    if n == 0:
        return np.zeros(0, bool)
    sel = _select_kernels(min(n, _MAX_BUCKET), device)
    if not _is_warm_bucket(sel.bucket, sel.n_dev):
        raise RuntimeError(f"dispatch shape {sel.bucket} is not a bucket (mesh of {sel.n_dev})")
    in_flight = []
    for i in range(0, n, _MAX_BUCKET):
        chunk = get_entries(i, min(i + _MAX_BUCKET, n))
        ops = _to_device(prepare_batch_eq(chunk, pad_to=sel.bucket, rand_bytes=rand_bytes), device)
        in_flight.append((chunk, sel.kernel_eq(*ops)))
    ids = [str(d) for d in sel.devices] if sel.devices else None
    shards = [0] * len(ids) if ids else None
    outs = []
    for chunk, (bitmap, eq_ok) in in_flight:
        if not bool(eq_ok):
            bitmap = sel.kernel_sig(*_to_device(prepare_resolved(chunk, pad_to=sel.bucket), device))
        outs.append(bitmap.cpu().numpy()[: len(chunk)])
        if ids:
            shards = [a + b for a, b in zip(shards, _shard_fill(len(chunk), sel.bucket, len(ids)))]
    if ids:
        _dispatch_local.info = {"devices": ids, "shards": shards}
    return outs[0] if len(outs) == 1 else np.concatenate(outs)


def verify_resolved(
    entries: list[ResolvedSig | None],
    device=DEFAULT_DEVICE,
    *,
    rand_bytes: RandBytes | None = None,
) -> np.ndarray:
    """Batch-equation verification with per-signature attribution: a
    bool bitmap of length len(entries). Sharded over the mesh when it
    holds more than one device of `device`'s type and the batch fills a
    floor bucket on each (TMTPU_FORCE_SHARDED=1 drops the size gate)."""
    dev = resolve_device(device)
    return _dispatch_and_collect(len(entries), lambda i, j: entries[i:j], dev, rand_bytes)


def verify_batch_eq(
    items: list[tuple[bytes, bytes, bytes]],
    device=DEFAULT_DEVICE,
    *,
    rand_bytes: RandBytes | None = None,
) -> np.ndarray:
    """(pubkey32, msg, sig64) ed25519 triples -> bool bitmap. Resolution
    (the SHA-512 per signature) runs per chunk inside the dispatch loop."""
    dev = resolve_device(device)
    return _dispatch_and_collect(
        len(items),
        lambda i, j: [resolve_ed25519(*it) for it in items[i:j]],
        dev,
        rand_bytes,
    )


class DeviceBatchVerifier(BatchVerifier):
    """BatchVerifier backed by `kernel_eq` on the card (the reference's
    `TPUBatchVerifier`, crypto/crypto.go:46-54 interface). ed25519 and
    sr25519 keys share the equation (see ResolvedSig); every other key
    type (secp256k1) is verified on the host (`pub_key.verify_signature`),
    so a mixed validator set still gets one complete bitmap."""

    def __init__(self, device=DEFAULT_DEVICE, *, rand_bytes: RandBytes | None = None):
        self._device = resolve_device(device)
        self._rand_bytes = rand_bytes
        self._entries: list[ResolvedSig | None] = []
        self._host_items: list[tuple[int, PubKey, bytes, bytes]] = []

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.TYPE in ("ed25519", "sr25519"):
            self._entries.append(resolve(pub_key, msg, sig))
        else:
            self._host_items.append((len(self._entries), pub_key, msg, sig))
            self._entries.append(None)

    def verify(self) -> tuple[bool, list[bool]]:
        _dispatch_local.info = None  # no dispatch when nothing resolved
        results = [False] * len(self._entries)
        if any(e is not None for e in self._entries):
            bitmap = verify_resolved(
                self._entries, self._device, rand_bytes=self._rand_bytes
            )
            results = [bool(ok) for ok in bitmap]
        for i, pk, msg, sig in self._host_items:
            results[i] = pk.verify_signature(msg, sig)
        return all(results) and bool(results), results
