"""Batched SHA-256 on the card — the HashHub's device route (the port's copy
of tendermint_tpu/crypto/tpu/sha256.py, whose jitted XLA graph
`_make_kernel` becomes the hand-written kernel B8, csrc/sha256.cu).

One kernel launch hashes a whole bucket of independent messages: one
thread per message runs the compression function over its own blocks.
Merkle work is uniform — `0x01||left||right` inner nodes are 65 bytes (2
blocks) and leaves cluster by size — which is what makes fixed-shape
buckets pay.

Shape discipline (the reference's): messages are host-padded to a
power-of-two block count (`block_bucket`, at most 8 blocks, so messages
of at most 503 bytes) and the batch to the bucket ladder 16…4,096
(`batch_bucket`); a message absorbs block t only while t is below its own
padded block count, so one bucket mixes message sizes.

Words travel as int32 tensors holding the uint32 bit patterns (the
wrapper views the host's uint32 words, it converts no value). On a CUDA
tensor `sha256_batch` launches the kernel; on a CPU tensor it runs the
plain version `_sha256_plain`, which computes in int64 masked to 32 bits
(PyTorch's CPU uint32 has no shifts to rely on). There is no fallback:
a kernel that does not build or launch raises, and so does a message
longer than the device unroll — the hub routes those to the host before
it dispatches.

With tracing on, `sha256_device` times its parts per chunk as `hash`
spans: ``hash.prepare`` (`prepare_hash_batch`), ``hash.h2d`` (the copies
in), ``hash.launch`` (`sha256_batch`: the launch, which returns before
the kernel ends) and ``hash.d2h`` (the copy out, which waits for the
kernel). With tracing off it reads no clock.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve
from ...libs import trace
from . import _build

#: bucket ladder for the batch axis (messages per kernel launch)
_MIN_BUCKET = 16
_MAX_BUCKET = 4096
#: largest padded block count the kernel absorbs (8 blocks = 512 bytes of
#: padded message, i.e. messages up to 503 bytes). Longer messages (64 KiB
#: block parts) are host work.
_MAX_BLOCKS = 8

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_M32 = 0xFFFFFFFF


def max_device_bytes() -> int:
    """Largest message the kernel accepts: 64 * _MAX_BLOCKS bytes minus
    the 0x80 terminator and the 8-byte length word."""
    return 64 * _MAX_BLOCKS - 9


def batch_bucket(n: int) -> int:
    """Power-of-two batch bucket, 16…4,096."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, _MAX_BUCKET)


def block_bucket(nblocks: int) -> int:
    """Power-of-two padded-block bucket."""
    b = 1
    while b < nblocks:
        b *= 2
    return b


def _padded_blocks(length: int) -> int:
    """Blocks the standard SHA-256 padding of a `length`-byte message
    occupies (0x80 terminator + 64-bit big-endian bit length)."""
    return (length + 8) // 64 + 1


def prepare_hash_batch(
    msgs: list[bytes], *, pad_to: int, block_pad: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host prep: pack messages (standard SHA-256 padding applied) into a
    (pad_to, block_pad, 16) big-endian uint32 word array plus the
    per-message padded block counts (uint32; 0 for the pad rows)."""
    raw = np.zeros((pad_to, block_pad * 64), np.uint8)
    nblk = np.zeros((pad_to,), np.uint32)
    for i, m in enumerate(msgs):
        length = len(m)
        nb = _padded_blocks(length)
        end = nb * 64
        if length:
            raw[i, :length] = np.frombuffer(m, np.uint8)
        raw[i, length] = 0x80
        raw[i, end - 8 : end] = np.frombuffer((length * 8).to_bytes(8, "big"), np.uint8)
        nblk[i] = nb
    words = raw.reshape(pad_to, block_pad, 16, 4).astype(np.uint32)
    packed = (
        (words[..., 0] << 24) | (words[..., 1] << 16)
        | (words[..., 2] << 8) | words[..., 3]
    )
    return packed, nblk


# -- B8: the batched compression -------------------------------------------

SHA256 = _build.Kernel(
    "sha256_batch",
    "sha256",
    [_build.P, _build.P, _build.P, _build.I64, _build.I32, _build.I32, _build.P],
    replaces="tendermint_tpu/crypto/tpu/sha256.py:107 (_make_kernel, jit :156)",
)


def sha256_batch(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """Digest words of a bucket: `blocks` (B, T, 16) int32 (the uint32
    big-endian words' bit patterns), `nblk` (B,) int32 block counts →
    (B, 8) int32 state words. Message i absorbs blocks t < nblk[i]."""
    if blocks.dtype != torch.int32 or blocks.dim() != 3 or blocks.shape[2] != 16:
        raise ValueError(f"expected (B, T, 16) int32 words, got {blocks.dtype} {tuple(blocks.shape)}")
    if nblk.dtype != torch.int32 or nblk.shape != blocks.shape[:1]:
        raise ValueError(f"expected ({blocks.shape[0]},) int32 block counts, got {nblk.dtype} "
                         f"{tuple(nblk.shape)}")
    if blocks.device.type == "cuda":
        return _sha256_cuda(blocks, nblk)
    if blocks.device.type == "cpu":
        return _sha256_plain(blocks, nblk)
    raise ValueError(f"no SHA-256 for tensors on {blocks.device}")


def _sha256_cuda(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    if nblk.device != blocks.device:
        raise ValueError(f"block counts on {nblk.device}, words on {blocks.device}")
    blocks, nblk = blocks.contiguous(), nblk.contiguous()
    if blocks.data_ptr() % 16:
        raise ValueError("the kernel reads the words 16 bytes at a time: align them to 16 bytes")
    b, t = blocks.shape[:2]
    out = torch.empty((b, 8), dtype=torch.int32, device=blocks.device)
    if b:
        SHA256(blocks.data_ptr(), nblk.data_ptr(), out.data_ptr(), b, t,
               *_build.stream_args(blocks))
    return out


def _sha256_plain(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """The plain version: the reference graph's arithmetic, vectorised
    over the batch, in int64 masked to 32 bits."""
    w_all = blocks.to(torch.int64) & _M32
    b, t_bucket = blocks.shape[:2]
    counts = nblk.to(torch.int64)

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & _M32

    state = torch.tensor(_H0, dtype=torch.int64, device=blocks.device).expand(b, 8)
    for t in range(t_bucket):
        w = [w_all[:, t, j] for j in range(16)]
        for j in range(16, 64):
            s0 = rotr(w[j - 15], 7) ^ rotr(w[j - 15], 18) ^ (w[j - 15] >> 3)
            s1 = rotr(w[j - 2], 17) ^ rotr(w[j - 2], 19) ^ (w[j - 2] >> 10)
            w.append((w[j - 16] + s0 + w[j - 7] + s1) & _M32)
        a, b_, c, d, e, f, g, h = state.unbind(1)
        for j in range(64):
            s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ ((e ^ _M32) & g)
            t1 = (h + s1 + ch + _K[j] + w[j]) & _M32
            s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & b_) ^ (a & c) ^ (b_ & c)
            h, g, f, e, d, c, b_, a = g, f, e, (d + t1) & _M32, c, b_, a, (t1 + s0 + maj) & _M32
        new = (torch.stack([a, b_, c, d, e, f, g, h], dim=1) + state) & _M32
        state = torch.where((counts > t)[:, None], new, state)
    return torch.where(state >= 1 << 31, state - (1 << 32), state).to(torch.int32)


def sha256_device(msgs: list[bytes], *, device=DEFAULT_DEVICE) -> list[bytes]:
    """Hash every message in bucket-shaped launches of at most 4,096
    messages on `device`. Raises ValueError on a message longer than
    `max_device_bytes()` (the caller routes those to the host), and on
    any kernel error."""
    dev = resolve(device)
    if not msgs:
        return []
    limit = max_device_bytes()
    nb_max = 1
    for m in msgs:
        if len(m) > limit:
            raise ValueError(
                f"message of {len(m)} bytes exceeds the device unroll "
                f"({limit} bytes) — host path required"
            )
        nb = _padded_blocks(len(m))
        if nb > nb_max:
            nb_max = nb
    t_bucket = block_bucket(nb_max)
    tracing = trace.is_enabled()
    out: list[bytes] = []
    for lo in range(0, len(msgs), _MAX_BUCKET):
        chunk = msgs[lo : lo + _MAX_BUCKET]
        b_bucket = batch_bucket(len(chunk))
        t0 = time.perf_counter() if tracing else 0.0
        packed, nblk = prepare_hash_batch(chunk, pad_to=b_bucket, block_pad=t_bucket)
        if tracing:
            t1 = time.perf_counter()
            trace.emit("hash", "prepare", duration_s=t1 - t0, shape=(b_bucket, t_bucket))
        words = torch.from_numpy(packed.view(np.int32)).to(dev)
        counts = torch.from_numpy(nblk.view(np.int32)).to(dev)
        if tracing:
            t2 = time.perf_counter()
            trace.emit("hash", "h2d", duration_s=t2 - t1)
        state = sha256_batch(words, counts)
        if tracing:
            t3 = time.perf_counter()
            trace.emit("hash", "launch", duration_s=t3 - t2)
        state = state.cpu().numpy()
        if tracing:
            trace.emit("hash", "d2h", duration_s=time.perf_counter() - t3)
        digests = state[: len(chunk)].view(np.uint32).astype(">u4").tobytes()
        out.extend(digests[i * 32 : (i + 1) * 32] for i in range(len(chunk)))
    return out
