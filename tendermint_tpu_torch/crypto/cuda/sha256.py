"""Batched SHA-256 on the card — the HashHub's device route (the port's copy
of tendermint_tpu/crypto/tpu/sha256.py, whose jitted XLA graph
`_make_kernel` becomes the hand-written kernel B8, csrc/sha256.cu).

The batch travels as it is: the messages' bytes joined end to end in one
uint8 buffer and n + 1 int64 offsets (message k is bytes
[offsets[k], offsets[k + 1])). One launch hashes the whole batch: the
kernel pads each message itself (0x80, zeros, the bit length) and writes
(n, 32) digest bytes in byte order. Messages are at most 503 bytes (eight
padded blocks); longer ones (64 KiB block parts) are host work.

`sha256_bytes(buf, offsets)` is the bytes-level entry. The offsets lie on
the host, where they are checked (every message inside the buffer, none
longer than 503 bytes) without reading the card. On a CUDA buffer it
launches B8; on a CPU buffer it runs the plain version,
`_sha256_bytes_plain`, which is the reference's own route: split the
buffer, pack on the host with `prepare_hash_batch` at the reference's
buckets (`batch_bucket`, at most 4,096 messages a chunk, and
`block_bucket`), compress with `_sha256_plain` (the reference graph's
arithmetic in int64 masked to 32 bits), then slice and byte-order. There
is no fallback: on a CUDA buffer the kernel launches or the call raises.
`sha256_batch` is the words-level plain compression on CPU tensors; it has
no kernel of its own.

`sha256_device(msgs, device=)` is what the HashHub calls: the lengths and
offsets with numpy, one `bytearray.join` of the messages, one copy in, one
`sha256_bytes` call (the offsets' check and copy, one launch), one copy
out. With tracing on it times its parts as `hash` spans, one set a call:
``hash.prepare`` (lengths, offsets, the join), ``hash.h2d`` (the copy in),
``hash.launch`` (`sha256_bytes`, which returns before the kernel ends; on
the CPU the plain version) and ``hash.d2h`` (the copy out, which waits for
the kernel, and the split into digests). With tracing off it reads no
clock.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve
from ...libs import trace
from . import _build

#: bucket ladder for the batch axis of the plain version (messages per
#: chunk, the reference's)
_MIN_BUCKET = 16
_MAX_BUCKET = 4096
#: largest padded block count the kernel absorbs (8 blocks = 512 bytes of
#: padded message, i.e. messages up to 503 bytes). Longer messages (64 KiB
#: block parts) are host work.
_MAX_BLOCKS = 8
#: messages a thread block of B8 hashes (csrc/sha256.cu kMsgs)
_BLOCK_MSGS = 32

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


def message_lengths(msgs: list[bytes]) -> np.ndarray:
    """The messages' lengths as an int64 array."""
    return np.fromiter(map(len, msgs), np.int64, len(msgs))


def _check_lengths(lengths: np.ndarray) -> int:
    """The longest message's length; the reference's ValueError on the
    first message longer than the kernel takes."""
    limit = max_device_bytes()
    longest = int(lengths.max()) if lengths.size else 0
    if longest > limit:
        first = int(lengths[np.argmax(lengths > limit)])
        raise ValueError(
            f"message of {first} bytes exceeds the device unroll "
            f"({limit} bytes) — host path required"
        )
    return longest


def _stage_bytes(n: int, longest: int) -> int:
    """Shared memory a thread block of B8 stages: its messages' span (at
    most 32 of the longest message), rounded out to 16 bytes at both ends,
    plus the 16 bytes a message's last word may read past it."""
    return (min(n, _BLOCK_MSGS) * longest + 30) // 16 * 16 + 16


# -- B8: the batch from its bytes ---------------------------------------------

SHA256 = _build.Kernel(
    "sha256_bytes",
    "sha256",
    [_build.P, _build.I64, _build.P, _build.P, _build.I64, _build.I32, _build.I32, _build.P],
    replaces="tendermint_tpu/crypto/tpu/sha256.py:107 (_make_kernel, jit :156)",
)


def sha256_bytes(buf: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Digests of the messages packed in `buf`, a 1-D uint8 tensor:
    message k is bytes [offsets[k], offsets[k + 1]) of it, `offsets` a 1-D
    int64 CPU tensor of n + 1 entries → (n, 32) uint8 digests on buf's
    device. Raises ValueError on anything else: offsets that leave the
    buffer or decrease, a message over 503 bytes (the reference's text),
    and on the card a buffer that is not 16-byte aligned."""
    if not isinstance(buf, torch.Tensor) or buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"expected a 1-D uint8 buffer, got {_describe(buf)}")
    if (not isinstance(offsets, torch.Tensor) or offsets.dtype != torch.int64
            or offsets.dim() != 1 or offsets.numel() < 1):
        raise ValueError(f"expected 1-D int64 offsets, n + 1 of them, got {_describe(offsets)}")
    if offsets.device.type != "cpu":
        raise ValueError(f"offsets on {offsets.device}: they are checked on the host, "
                         f"pass them as a CPU tensor")
    off = offsets.numpy()
    lengths = np.diff(off)
    if off[0] < 0 or (lengths < 0).any() or off[-1] > buf.numel():
        raise ValueError(f"offsets {off[0]}…{off[-1]} leave the {buf.numel()}-byte buffer "
                         f"or decrease")
    longest = _check_lengths(lengths)
    if buf.device.type == "cuda":
        return _bytes_cuda(buf, offsets.to(buf.device), _stage_bytes(lengths.size, longest))
    if buf.device.type == "cpu":
        return _sha256_bytes_plain(buf, offsets)
    raise ValueError(f"no SHA-256 for tensors on {buf.device}")


def _describe(t) -> str:
    if isinstance(t, torch.Tensor):
        return f"{t.dtype} {tuple(t.shape)} on {t.device}"
    return type(t).__name__


def _bytes_cuda(buf: torch.Tensor, offsets: torch.Tensor, stage_bytes: int) -> torch.Tensor:
    """Launch B8 on the operands `sha256_bytes` checked: `offsets` copied to
    buf's card, `stage_bytes` from `_stage_bytes` for these messages."""
    buf, offsets = buf.contiguous(), offsets.contiguous()
    if buf.data_ptr() % 16:
        raise ValueError("the kernel reads the buffer 16 bytes at a time: align it to 16 bytes")
    n = offsets.numel() - 1
    out = torch.empty((n, 32), dtype=torch.uint8, device=buf.device)
    if n:
        SHA256(buf.data_ptr(), buf.numel(), offsets.data_ptr(), out.data_ptr(), n, stage_bytes,
               *_build.stream_args(buf))
    return out


def _sha256_bytes_plain(buf: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of B8, the reference's route: split the buffer,
    pack each chunk of at most 4,096 messages with `prepare_hash_batch` at
    the reference's buckets, compress with `_sha256_plain` on buf's device,
    then keep the real rows and order the bytes. `offsets` on the host."""
    off = offsets.tolist()
    n = len(off) - 1
    data = buf.cpu().numpy().tobytes()
    msgs = [data[off[k] : off[k + 1]] for k in range(n)]
    if not n:
        return torch.empty((0, 32), dtype=torch.uint8, device=buf.device)
    t_bucket = block_bucket(max(_padded_blocks(len(m)) for m in msgs))
    states = []
    for lo in range(0, n, _MAX_BUCKET):
        chunk = msgs[lo : lo + _MAX_BUCKET]
        packed, nblk = prepare_hash_batch(chunk, pad_to=batch_bucket(len(chunk)), block_pad=t_bucket)
        words = torch.from_numpy(packed.view(np.int32)).to(buf.device)
        counts = torch.from_numpy(nblk.view(np.int32)).to(buf.device)
        states.append(_sha256_plain(words, counts)[: len(chunk)])
    return _digest_bytes(torch.cat(states))


def _digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """(B, 8) int32 state words → (B, 32) uint8 digests (big-endian)."""
    w = state.to(torch.int64) & _M32
    parts = torch.stack([(w >> 24) & 255, (w >> 16) & 255, (w >> 8) & 255, w & 255], dim=2)
    return parts.reshape(-1, 32).to(torch.uint8)


# -- the words-level plain compression ------------------------------------------


def sha256_batch(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """Digest words of a bucket on the CPU: `blocks` (B, T, 16) int32 (the
    uint32 big-endian words' bit patterns), `nblk` (B,) int32 block counts
    → (B, 8) int32 state words. Message i absorbs blocks t < nblk[i]. No
    kernel computes this: on the card, hash bytes with `sha256_bytes`."""
    if blocks.dtype != torch.int32 or blocks.dim() != 3 or blocks.shape[2] != 16:
        raise ValueError(f"expected (B, T, 16) int32 words, got {blocks.dtype} {tuple(blocks.shape)}")
    if nblk.dtype != torch.int32 or nblk.shape != blocks.shape[:1]:
        raise ValueError(f"expected ({blocks.shape[0]},) int32 block counts, got {nblk.dtype} "
                         f"{tuple(nblk.shape)}")
    if blocks.device.type == "cpu" and nblk.device.type == "cpu":
        return _sha256_plain(blocks, nblk)
    raise ValueError(f"sha256_batch has no kernel (words on {blocks.device}): on the card, "
                     f"hash the messages' bytes with sha256_bytes")


def _sha256_plain(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """The plain compression: the reference graph's arithmetic, vectorised
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


# -- the HashHub's route ------------------------------------------------------------


def sha256_device(msgs: list[bytes], *, device=DEFAULT_DEVICE,
                  lengths: np.ndarray | None = None) -> list[bytes]:
    """Hash every message on `device` in one `sha256_bytes` call. `lengths`,
    when the caller has measured them, are `message_lengths(msgs)`. Raises
    ValueError on a message longer than `max_device_bytes()` (the caller
    routes those to the host), and on any kernel error."""
    dev = resolve(device)
    if not msgs:
        return []
    tracing = trace.is_enabled()
    t0 = time.perf_counter() if tracing else 0.0
    if lengths is None:
        lengths = message_lengths(msgs)
    offsets = np.zeros(len(msgs) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    joined = bytearray().join(msgs)
    if tracing:
        t1 = time.perf_counter()
        trace.emit("hash", "prepare", duration_s=t1 - t0, n=len(msgs), bytes=len(joined))
    buf = torch.frombuffer(joined, dtype=torch.uint8) if joined else torch.empty(0, dtype=torch.uint8)
    buf = buf.to(dev)
    if tracing:
        t2 = time.perf_counter()
        trace.emit("hash", "h2d", duration_s=t2 - t1)
    digests = sha256_bytes(buf, torch.from_numpy(offsets))
    if tracing:
        t3 = time.perf_counter()
        trace.emit("hash", "launch", duration_s=t3 - t2)
    out = digests.cpu().numpy().view("V32").ravel().tolist()
    if tracing:
        trace.emit("hash", "d2h", duration_s=time.perf_counter() - t3)
    return out
