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

Pinned differences by design: a device error raises out of `sha256_many`
(the reference re-hashes the batch on the host behind its breaker), and
the route is switched with `hash_hub.use_device` (the reference reads
TMTPU_HASH_TPU=1).
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


def test_sha256_device_spans_two_chunks():
    msgs = [b"\x01" + i.to_bytes(4, "big") * 16 for i in range(4097)]  # 65 bytes: two blocks
    out = S.sha256_device(msgs, device="cpu")
    assert len(out) == 4097
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

    def broken(msgs, *, device):
        raise RuntimeError("CUDA kernel sha256_batch failed to launch: error 700")

    monkeypatch.setattr(S, "sha256_device", broken)
    with pytest.raises(RuntimeError, match="sha256_batch"):
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
    assert [s["name"] for s in spans] == ["prepare", "h2d", "launch", "d2h"] * 2
    assert [s["attrs"]["shape"] for s in spans if s["name"] == "prepare"] == [(4096, 2), (16, 2)]


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
