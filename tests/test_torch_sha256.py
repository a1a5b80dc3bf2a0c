"""The port's SHA-256 device route (crypto/cuda/sha256.py, kernel B8, and the
HashHub's route to it) against the JAX package's, on the CPU.

The reference's jitted graph (`crypto/tpu/sha256._make_kernel`) unrolls 64
rounds per block over the batch; on a CPU its first call, at one block and
16 messages, runs for more than fifteen minutes, so it is not run here. The port is held instead against what the reference's
own tests hold that graph to: its host preparation (`prepare_hash_batch`,
the bucket ladder), its host route, and hashlib, byte for byte. On the CPU
the wrapper runs the kernel's plain version; the kernel itself is held to
that plain version on the card (tests/test_torch_kernels.py). Integer
arithmetic: the tolerance is zero.

B8 takes the messages' bytes joined end to end and their offsets, pads on
the card and hashes a batch in one launch; its plain version, which the
bytes entry `sha256_bytes` runs on a CPU buffer, is the reference's route
(host packing with `prepare_hash_batch` at the reference's buckets, the
compression, the byte order), held here to that packing and to hashlib on
mixed lengths at every alignment.

Pinned differences by design: a device error raises out of `sha256_many`
(the reference re-hashes the batch on the host behind its breaker); the
route is switched with `hash_hub.use_device` (the reference reads
TMTPU_HASH_TPU=1); the padding and packing happen on the card, from the
bytes and offsets (the reference packs on the host); and a batch is one
launch of the bytes entry whatever its width, with no bucket padding (the
reference launches once per bucket of at most 4,096).
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import hash_hub as ref_hub
from tendermint_tpu.crypto import merkle as ref_merkle
from tendermint_tpu.crypto.tpu import sha256 as ref_sha
from tendermint_tpu_torch.crypto import hash_hub as hub
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.cuda import sha256 as S

torch.set_num_threads(1)

#: the padding edges: one block up to 55 bytes, two from 56, 119/120 the
#: two/three-block edge, 250 the leaf shape, 503 the device limit
EDGES = (0, 1, 55, 56, 63, 64, 65, 119, 120, 250, 503)


def _msgs(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 10**5])
def test_buckets_match_reference(n):
    assert S.batch_bucket(n) == ref_sha.batch_bucket(n)
    assert S.block_bucket(max(n % 9, 1)) == ref_sha.block_bucket(max(n % 9, 1))
    assert S._padded_blocks(n % 504) == ref_sha._padded_blocks(n % 504)
    assert S.max_device_bytes() == ref_sha.max_device_bytes() == 503


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_prepare_hash_batch_matches_reference(t):
    top = 64 * t - 9
    lengths = sorted({n for n in EDGES if n <= top} | set(range(0, top + 1, 37)) | {top})
    msgs = _msgs(lengths)
    pad = S.batch_bucket(len(msgs) + 1)
    mine = S.prepare_hash_batch(msgs, pad_to=pad, block_pad=t)
    ref = ref_sha.prepare_hash_batch(msgs, pad_to=pad, block_pad=t)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype == np.uint32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_sha256_device_on_cpu_equals_hashlib(t):
    top = 64 * t - 9
    lengths = [n for n in EDGES if n <= top] * 3
    msgs = _msgs(lengths, seed=t)
    assert S.block_bucket(max(S._padded_blocks(len(m)) for m in msgs)) == t
    out = S.sha256_device(msgs, device="cpu")
    assert out == [hashlib.sha256(m).digest() for m in msgs]


def test_sha256_device_spans_two_chunks(monkeypatch):
    """4,097 messages, past the reference's 4,096 bucket, go through the
    bytes entry once (its plain version chunks them as the reference does)."""
    calls = []
    plain = S._sha256_bytes_plain
    monkeypatch.setattr(S, "_sha256_bytes_plain", lambda *a: calls.append(a) or plain(*a))
    msgs = [b"\x01" + i.to_bytes(4, "big") * 16 for i in range(4097)]  # 65 bytes: two blocks
    out = S.sha256_device(msgs, device="cpu")
    assert len(out) == 4097 and len(calls) == 1
    assert out == [hashlib.sha256(m).digest() for m in msgs]


def test_plain_version_leaves_pad_rows_at_the_initial_state():
    packed, nblk = S.prepare_hash_batch([b"abc"], pad_to=16, block_pad=2)
    state = S.sha256_batch(torch.from_numpy(packed.view(np.int32)),
                           torch.from_numpy(nblk.view(np.int32)))
    words = state.numpy().view(np.uint32)
    assert words[0].astype(">u4").tobytes() == hashlib.sha256(b"abc").digest()
    assert (words[1:] == np.array(S._H0, np.uint32)).all()


def test_over_limit_message_raises_as_the_reference_does():
    msgs = [b"ok", b"x" * 504]
    with pytest.raises(ValueError) as mine:
        S.sha256_device(msgs, device="cpu")
    with pytest.raises(ValueError) as ref:
        ref_sha.sha256_device(msgs)  # raises before any JAX call
    assert str(mine.value) == str(ref.value)


def test_wrapper_refuses_wrong_types():
    with pytest.raises(ValueError, match="int32 words"):
        S.sha256_batch(torch.zeros((16, 1, 16), dtype=torch.int64), torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="block counts"):
        S.sha256_batch(torch.zeros((16, 1, 16), dtype=torch.int32), torch.zeros(8, dtype=torch.int32))


@pytest.fixture
def device_route(monkeypatch):
    """The hub's device route on the CPU (the kernel's plain version) from
    16 messages, reset afterwards."""
    monkeypatch.setattr(hub, "MIN_DEVICE_BATCH", 16)
    hub.use_device("cpu")
    hub.reset_stats()
    yield
    hub.use_device(None)
    hub.reset_stats()


def test_hub_device_route_equals_reference_host_route(device_route):
    msgs = _msgs([65] * 40 + [250] * 24)
    before = dict(ref_hub.STATS)
    assert hub.sha256_many(msgs) == ref_hub.sha256_many(msgs)
    assert ref_hub.STATS["device_batches"] == before["device_batches"]  # the reference stayed on the host
    assert hub.STATS["device_batches"] == 1
    assert hub.STATS["device_messages"] == 64
    assert hub.STATS["batches"] == 1 and hub.STATS["messages"] == 64


def test_hub_routes_narrow_batches_and_long_messages_to_the_host(device_route):
    narrow = _msgs([65] * 15)
    long_ = _msgs([65] * 20 + [504])
    assert hub.sha256_many(narrow) == [hashlib.sha256(m).digest() for m in narrow]
    assert hub.sha256_many(long_) == [hashlib.sha256(m).digest() for m in long_]
    assert hub.STATS["device_batches"] == 0 and hub.STATS["device_messages"] == 0
    assert hub.STATS["batches"] == 2 and hub.STATS["messages"] == 36


def test_hub_route_is_off_by_default():
    assert hub._device is None
    msgs = _msgs([65] * 300)
    hub.reset_stats()
    assert hub.sha256_many(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert hub.STATS["device_batches"] == 0


def test_use_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hub.use_device("cuda")
    assert hub._device is None


def test_device_error_raises_out_of_sha256_many(device_route, monkeypatch):
    """The reference degrades to a host re-hash behind its breaker
    (tests/test_hash_hub.py's test_device_error_degrades_to_host); the
    port raises."""

    def broken(msgs, **kw):
        raise RuntimeError("CUDA kernel sha256_bytes failed to launch: error 700")

    monkeypatch.setattr(S, "sha256_device", broken)
    with pytest.raises(RuntimeError, match="sha256_bytes"):
        hub.sha256_many(_msgs([65] * 32))
    assert hub.STATS["device_batches"] == 0


def test_hash_batch_span_names_the_route(device_route):
    from tendermint_tpu_torch.libs import trace

    trace.configure(enabled=True)
    trace.RECORDER.clear()
    hub.sha256_many(_msgs([65] * 16))
    hub.use_device(None)
    hub.sha256_many(_msgs([65] * 16))
    routes = [s["attrs"]["route"] for s in trace.RECORDER.dump(subsystem="hash")
              if s["name"] == "batch"]
    assert routes == ["plain", "cpu"]


@pytest.mark.parametrize("enabled", [True, False])
def test_sha256_device_spans_its_parts_per_chunk(enabled):
    from tendermint_tpu_torch.libs import trace

    trace.RECORDER.clear()
    trace.configure(enabled=enabled)
    try:
        S.sha256_device(_msgs([65] * 4097), device="cpu")
        spans = trace.RECORDER.dump(subsystem="hash")
    finally:
        trace.configure(enabled=True)
        trace.RECORDER.clear()
    if not enabled:
        assert spans == []
        return
    assert [s["name"] for s in spans] == ["prepare", "h2d", "launch", "d2h"]  # one set a call
    assert (spans[0]["attrs"]["n"], spans[0]["attrs"]["bytes"]) == (4097, 65 * 4097)


@pytest.mark.parametrize("n", [64, 1024])
def test_merkle_roots_and_proofs_through_the_device_route(device_route, n):
    leaves = [bytes([i % 256, (i >> 8) % 256]) * 125 for i in range(n)]  # bench_merkle's leaves
    root = merkle.hash_from_byte_slices(leaves)
    assert root == ref_merkle.hash_from_byte_slices(leaves)
    assert root == ref_merkle.hash_from_byte_slices_scalar(leaves)
    proot, proofs = merkle.proofs_from_byte_slices(leaves[:64])
    rroot, rproofs = ref_merkle.proofs_from_byte_slices(leaves[:64])
    assert proot == rroot
    assert [(p.total, p.index, p.leaf_hash, list(p.aunts)) for p in proofs] == \
        [(p.total, p.index, p.leaf_hash, list(p.aunts)) for p in rproofs]
    assert hub.STATS["device_batches"] >= 2


# -- the bytes entry ---------------------------------------------------------------

#: the padding edges and the leaf shapes, mixed in each batch
BYTES_EDGES = (0, 1, 55, 56, 63, 64, 65, 119, 120, 250, 251, 503)


def _packed(n, prefix, seed=3):
    """n messages of the edges' lengths, cycled from a place that depends
    on n, joined after `prefix` bytes: (messages, buffer, offsets)."""
    lengths = [BYTES_EDGES[(i * 5 + n) % len(BYTES_EDGES)] for i in range(n)]
    msgs = _msgs(lengths, seed=seed)
    raw = bytes(range(7, 7 + prefix)) + b"".join(msgs)
    buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    offsets = torch.from_numpy(np.cumsum([prefix] + lengths).astype(np.int64))
    return msgs, buf, offsets


def _digests(t: torch.Tensor) -> list[bytes]:
    return [bytes(row) for row in t.numpy()]


@pytest.mark.parametrize("n,prefix", [(1, 0), (1, 13), (31, 5), (32, 0), (33, 7), (70, 15)])
def test_sha256_bytes_plain_equals_hashlib(n, prefix):
    msgs, buf, offsets = _packed(n, prefix)
    got = S.sha256_bytes(buf, offsets)
    assert got.dtype == torch.uint8 and got.shape == (n, 32)
    assert _digests(got) == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_sha256_bytes_plain_equals_reference_packing(t):
    """The plain version's digests are the reference's packing
    (`prepare_hash_batch` at its buckets) through the compression, limb for
    limb: the state words, byte-ordered."""
    top = 64 * t - 9
    lengths = [n for n in BYTES_EDGES if n <= top] * 2
    msgs = _msgs(lengths, seed=t + 10)
    buf = torch.frombuffer(bytearray(b"\xaa" * t + b"".join(msgs)), dtype=torch.uint8)
    offsets = torch.from_numpy(np.cumsum([t] + lengths).astype(np.int64))
    packed, nblk = ref_sha.prepare_hash_batch(
        msgs, pad_to=ref_sha.batch_bucket(len(msgs)),
        block_pad=ref_sha.block_bucket(max(ref_sha._padded_blocks(n) for n in lengths)))
    state = S._sha256_plain(torch.from_numpy(packed.view(np.int32)),
                            torch.from_numpy(nblk.view(np.int32)))[: len(msgs)]
    words = state.numpy().view(np.uint32).astype(">u4").tobytes()
    assert torch.equal(S.sha256_bytes(buf, offsets), S._digest_bytes(state))
    assert _digests(S._digest_bytes(state)) == [words[32 * i : 32 * i + 32] for i in range(len(msgs))]


_BUF = torch.zeros(64, dtype=torch.uint8)
_OFF = torch.tensor([0, 10, 20], dtype=torch.int64)


@pytest.mark.parametrize("buf,offsets,match", [
    (_BUF.to(torch.int32), _OFF, "1-D uint8 buffer"),
    (_BUF.reshape(8, 8), _OFF, "1-D uint8 buffer"),
    (b"bytes", _OFF, "1-D uint8 buffer"),
    (_BUF, _OFF.to(torch.int32), "int64 offsets"),
    (_BUF, _OFF.reshape(1, 3), "int64 offsets"),
    (_BUF, torch.zeros(0, dtype=torch.int64), "int64 offsets"),
    (_BUF, torch.tensor([-1, 10], dtype=torch.int64), "leave the 64-byte buffer"),
    (_BUF, torch.tensor([0, 10, 5], dtype=torch.int64), "or decrease"),
    (_BUF, torch.tensor([0, 65], dtype=torch.int64), "leave the 64-byte buffer"),
    (_BUF, _OFF.to("meta"), "checked on the host"),
    (_BUF.to("meta"), _OFF, "no SHA-256 for tensors on meta"),
])
def test_sha256_bytes_refuses(buf, offsets, match):
    with pytest.raises(ValueError, match=match):
        S.sha256_bytes(buf, offsets)


def test_sha256_bytes_over_limit_error_is_the_references():
    msgs = [b"ok", b"x" * 504, b"y" * 600]
    buf = torch.frombuffer(bytearray(b"".join(msgs)), dtype=torch.uint8)
    offsets = torch.tensor([0, 2, 506, 1106], dtype=torch.int64)
    with pytest.raises(ValueError) as mine:
        S.sha256_bytes(buf, offsets)
    with pytest.raises(ValueError) as ref:
        ref_sha.sha256_device(msgs)  # raises before any JAX call
    assert str(mine.value) == str(ref.value)


def test_sha256_bytes_of_no_message():
    got = S.sha256_bytes(torch.zeros(5, dtype=torch.uint8), torch.tensor([3], dtype=torch.int64))
    assert got.shape == (0, 32) and got.dtype == torch.uint8


def test_sha256_batch_names_the_bytes_entry_off_the_cpu():
    words = torch.zeros((16, 1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="sha256_bytes"):
        S.sha256_batch(words, torch.zeros(16, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_bytes_covers_every_thread_block(seed):
    """B8's shared memory holds each thread block's 32 messages, rounded out
    to 16 bytes at both ends, and the 16 bytes a last word may read past."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    lengths = rng.integers(0, 504, n)
    offsets = np.cumsum([int(rng.integers(0, 40))] + list(lengths)).astype(np.int64)
    stage = S._stage_bytes(n, int(lengths.max()))
    assert stage % 16 == 0
    for first in range(0, n, 32):
        lo, hi = offsets[first] & ~15, offsets[min(first + 32, n)]
        assert stage >= (hi - lo + 15) // 16 * 16 + 16


def test_sha256_device_keeps_digests_that_end_in_zero():
    """The copy out splits the (n, 32) bytes into digests with numpy: a
    digest whose last bytes are zero keeps them."""
    msgs = [b"z%d" % i for i in range(4000)]
    zero_tail = [m for m in msgs if hashlib.sha256(m).digest()[-1] == 0]
    assert zero_tail
    assert S.sha256_device(zero_tail + msgs[:20], device="cpu") == \
        [hashlib.sha256(m).digest() for m in zero_tail + msgs[:20]]


def test_hub_hands_the_route_its_lengths(device_route, monkeypatch):
    """The hub measures the lengths once: the route's check and packing
    reuse them."""
    seen = []
    route = S.sha256_device
    monkeypatch.setattr(S, "sha256_device",
                        lambda msgs, **kw: seen.append(kw["lengths"].tolist()) or route(msgs, **kw))
    msgs = _msgs([65] * 20 + [250] * 12 + [0])
    assert hub.sha256_many(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert seen == [[65] * 20 + [250] * 12 + [0]]


def test_sha256_device_goes_through_the_bytes_entry(monkeypatch):
    """One `sha256_bytes` call a batch, its offsets on the host: the bytes
    entry alone checks the batch and picks the kernel or the plain version."""
    calls = []
    entry = S.sha256_bytes
    monkeypatch.setattr(S, "sha256_bytes",
                        lambda buf, off: calls.append((buf.numel(), off.tolist())) or entry(buf, off))
    msgs = [b"", b"abc", b"x" * 64]
    assert S.sha256_device(msgs, device="cpu") == [hashlib.sha256(m).digest() for m in msgs]
    assert calls == [(67, [0, 0, 3, 67])]


def test_sha256_device_of_empty_messages_only():
    assert S.sha256_device([b""] * 3, device="cpu") == [hashlib.sha256(b"").digest()] * 3
