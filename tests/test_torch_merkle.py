"""The port's Merkle trees and HashHub against the JAX package's, on the
CPU: roots, proofs (their fields and encodings), proof operators and the
HashHub's per-lane accounting are byte- and count-identical at every tree
shape class of tests/test_hash_hub.py (0–69 leaves, and 2^k, 2^k ± 1 up
to 1,025). The tolerance is zero."""

from __future__ import annotations

import pytest

from tendermint_tpu.crypto import hash_hub as j_hub
from tendermint_tpu.crypto import merkle as j_merkle
from tendermint_tpu_torch.crypto import hash_hub as p_hub
from tendermint_tpu_torch.crypto import merkle as p_merkle

TREE_SIZES = list(range(0, 70)) + [127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025]


def _items(n: int, size: int = 37) -> list[bytes]:
    # distinct leaves with varying first bytes (tests/test_hash_hub.py's)
    return [bytes([i & 0xFF, (i >> 8) & 0xFF]) + b"\xab" * size for i in range(n)]


@pytest.mark.parametrize("n", TREE_SIZES)
def test_root_and_proofs_byte_identical(n):
    items = _items(n)
    assert p_merkle.hash_from_byte_slices(items) == j_merkle.hash_from_byte_slices(items)
    p_root, p_proofs = p_merkle.proofs_from_byte_slices(items)
    j_root, j_proofs = j_merkle.proofs_from_byte_slices(items)
    assert p_root == j_root
    assert len(p_proofs) == len(j_proofs) == n
    for pp, jp in zip(p_proofs, j_proofs):
        assert (pp.total, pp.index, pp.leaf_hash, pp.aunts) == (
            jp.total, jp.index, jp.leaf_hash, jp.aunts
        )
        assert pp.encode() == jp.encode()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 14, 33, 129, 1025])
def test_proofs_verify_and_decode_across_packages(n):
    items = _items(n)
    root, p_proofs = p_merkle.proofs_from_byte_slices(items)
    for i in sorted({0, n // 2, n - 1}):
        pp = p_proofs[i]
        jp = j_merkle.Proof.decode(pp.encode())
        back = p_merkle.Proof.decode(jp.encode())
        assert (back.total, back.index, back.leaf_hash, back.aunts) == (
            pp.total, pp.index, pp.leaf_hash, pp.aunts
        )
        assert pp.verify(root, items[i]) and jp.verify(root, items[i])
        assert pp.verify(root, items[i], leaf_hash=pp.leaf_hash)
        assert not pp.verify(root, items[i] + b"x")
        assert not jp.verify(root, items[i] + b"x")


def test_proof_operators_and_key_paths_match():
    pairs = {b"k%d" % i: b"v%d" % i for i in range(11)}
    leaves = [p_merkle.kv_leaf(k, v) for k, v in sorted(pairs.items())]
    assert leaves == [j_merkle.kv_leaf(k, v) for k, v in sorted(pairs.items())]
    root, proofs = p_merkle.proofs_from_byte_slices(leaves)
    for (key, value), proof in zip(sorted(pairs.items()), proofs):
        p_op = p_merkle.value_op(key, proof)
        j_op = j_merkle.value_op(key, j_merkle.Proof.decode(proof.encode()))
        assert p_op.encode() == j_op.encode()
        assert p_merkle.ProofOp.decode(j_op.encode()).encode() == p_op.encode()
        path = p_merkle.key_path(key)
        assert path == j_merkle.key_path(key)
        assert p_merkle.ProofOperators([p_op]).verify_value(root, path, value)
        assert j_merkle.ProofOperators([j_op]).verify_value(root, path, value)
        assert not p_merkle.ProofOperators([p_op]).verify_value(root, path, value + b"!")


def _drive(hub, merkle):
    """The same calls through either package: trees on explicit lanes and
    under an ambient lane, a wide batch, and single digests."""
    merkle.hash_from_byte_slices(_items(5), lane=hub.LANE_VERIFY)
    merkle.proofs_from_byte_slices(_items(300), lane=hub.LANE_BUILD)
    with hub.lane_ctx(hub.LANE_LIGHT):
        merkle.hash_from_byte_slices(_items(17))
        with hub.lane_ctx(hub.LANE_VERIFY):
            hub.sha256_one(b"inner")
        hub.sha256_one(b"outer")
    out = hub.sha256_many([b"m%d" % i for i in range(257)])
    hub.sha256_one(b"one", lane=hub.LANE_BUILD)
    return out


def test_hash_hub_stats_per_lane_match_reference():
    p_hub.reset_stats()
    j_hub.reset_stats()
    assert _drive(p_hub, p_merkle) == _drive(j_hub, j_merkle)
    p_snap, j_snap = p_hub.stats_snapshot(), j_hub.stats_snapshot()
    for key in ("batches", "messages", "singles", "max_batch", "lane_batches", "lane_messages"):
        assert p_snap[key] == j_snap[key], key
    assert p_snap["lane_batches"]["light"] > 0 and p_snap["singles"] == 3
    assert j_snap["device_batches"] == 0  # the reference hashed on the host too
    with pytest.raises(ValueError):
        p_hub.lane_ctx("nope")
    assert p_hub.current_lane() == p_hub.LANE_BUILD
