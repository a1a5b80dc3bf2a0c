"""BLS12-381 key types (min-pubkey-size: 48-byte G1 pubkeys, 96-byte G2
signatures) and the aggregate-signature helpers behind the aggregate
commit path.

The port's copy of tendermint_tpu/crypto/bls.py. Signing and single
verification run on the pure-Python bls_math module; batched and
aggregate verification run the pairing kernels of
crypto/cuda/bls_pairing.py through crypto/batch.py's scheme-partitioned
dispatch. Decoded, subgroup-checked points are cached by encoding: a
validator pubkey is decompressed exactly once per process, and gossip
re-verifications of the same signature skip the G2 subgroup check.

Rogue-key defense: aggregate positions are guarded by proofs of
possession (`BLSPrivKey.pop_prove` / `BLSPubKey.pop_verify`, domain
separated from signing via DST_POP), checked at genesis / validator-set
construction (types/genesis.py) — not per verification.
"""

from __future__ import annotations

import secrets

from . import PrivKey, PubKey, register_pubkey_type
from . import bls_math

KEY_TYPE = "bls12381"
PUBKEY_SIZE = 48
PRIVKEY_SIZE = 32  # seed
SIGNATURE_SIZE = 96

# decode caches: encoding -> affine point (subgroup-checked) or False
# for invalid encodings. Validator pubkeys and gossiped commit sigs
# recur constantly; a G2 subgroup check costs ~10 ms in pure Python.
_PK_POINTS: dict[bytes, object] = {}
_SIG_POINTS: dict[bytes, object] = {}
_POINT_CACHE_MAX = 10_000

# verification memo, same rationale as ed25519's degraded-path memo —
# BLS verification is a pure function of (pubkey, msg, sig) and costs
# ~0.25 s in pure Python
_VERIFY_MEMO: dict[tuple[bytes, bytes, bytes], bool] = {}
_VERIFY_MEMO_MAX = 100_000

#: process-wide BLS counters, folded into /metrics as the bls_* family
#: (libs/metrics NodeMetrics._fold_bls). Pairings are expensive enough
#: that "how many, and how many signers per aggregate" is an
#: operational question, not a debug one.
STATS: dict[str, float] = {
    "verifies": 0.0,            # single-signature checks (memo misses)
    "verify_failures": 0.0,
    "aggregate_verifies": 0.0,  # aggregate-commit pairing products
    "aggregate_failures": 0.0,
    "aggregate_signers": 0.0,   # signers covered by aggregate checks
    "pop_checks": 0.0,          # proof-of-possession verifications
}


def _bounded_put(cache: dict, key, value, cap: int = _POINT_CACHE_MAX):
    if len(cache) >= cap:
        cache.clear()
    cache[key] = value
    return value


def pubkey_point(data: bytes):
    """48-byte encoding -> G1 point, on-curve + subgroup checked +
    not-infinity, cached; None for invalid."""
    hit = _PK_POINTS.get(data)
    if hit is not None:
        return hit or None
    try:
        pt = bls_math.g1_decompress(data)
    except ValueError:
        return _bounded_put(_PK_POINTS, data, False) or None
    if pt is None or not bls_math.g1_in_subgroup(pt):
        return _bounded_put(_PK_POINTS, data, False) or None
    return _bounded_put(_PK_POINTS, data, pt)


def signature_point(data: bytes):
    """96-byte encoding -> G2 point, subgroup checked, cached; None for
    invalid. Infinity is rejected (an infinity aggregate would verify
    against an empty signer set)."""
    hit = _SIG_POINTS.get(data)
    if hit is not None:
        return hit or None
    try:
        pt = bls_math.g2_decompress(data)
    except ValueError:
        return _bounded_put(_SIG_POINTS, data, False) or None
    if pt is None or not bls_math.g2_in_subgroup(pt):
        return _bounded_put(_SIG_POINTS, data, False) or None
    return _bounded_put(_SIG_POINTS, data, pt)


class BLSPubKey(PubKey):
    TYPE = KEY_TYPE

    def __init__(self, data: bytes):
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"bls12381 pubkey must be {PUBKEY_SIZE} bytes")
        self._bytes = bytes(data)

    def bytes(self) -> bytes:
        return self._bytes

    def point(self):
        return pubkey_point(self._bytes)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        key = (self._bytes, bytes(msg), bytes(sig))
        hit = _VERIFY_MEMO.get(key)
        if hit is not None:
            return hit
        pk = self.point()
        sp = signature_point(sig) if pk is not None else None
        ok = (
            pk is not None
            and sp is not None
            and bls_math.verify(pk, msg, sp)
        )
        STATS["verifies"] += 1
        if not ok:
            STATS["verify_failures"] += 1
        if len(_VERIFY_MEMO) >= _VERIFY_MEMO_MAX:
            _VERIFY_MEMO.clear()
        _VERIFY_MEMO[key] = ok
        return ok

    def pop_verify(self, pop: bytes) -> bool:
        """Proof-of-possession: a signature over this pubkey's encoding
        under the POP domain tag (rogue-key defense for aggregation).
        Memoized — genesis PoPs are re-checked per node per process."""
        if len(pop) != SIGNATURE_SIZE:
            return False
        key = (self._bytes, b"pop", bytes(pop))
        hit = _VERIFY_MEMO.get(key)
        if hit is not None:
            return hit
        pk = self.point()
        sp = signature_point(pop)
        ok = (
            pk is not None
            and sp is not None
            and bls_math.verify(pk, self._bytes, sp, dst=bls_math.DST_POP)
        )
        STATS["pop_checks"] += 1
        if len(_VERIFY_MEMO) >= _VERIFY_MEMO_MAX:
            _VERIFY_MEMO.clear()
        _VERIFY_MEMO[key] = ok
        return ok


class BLSPrivKey(PrivKey):
    TYPE = KEY_TYPE

    def __init__(self, seed: bytes):
        if len(seed) != PRIVKEY_SIZE:
            raise ValueError(f"bls12381 privkey seed must be {PRIVKEY_SIZE} bytes")
        self._seed = bytes(seed)
        self._sk = bls_math.keygen(self._seed)
        self._pub = bls_math.g1_compress(bls_math.sk_to_pk(self._sk))

    @classmethod
    def generate(cls) -> "BLSPrivKey":
        return cls(secrets.token_bytes(PRIVKEY_SIZE))

    def bytes(self) -> bytes:
        return self._seed

    def sign(self, msg: bytes) -> bytes:
        return bls_math.g2_compress(bls_math.sign(self._sk, msg))

    def pop_prove(self) -> bytes:
        return bls_math.g2_compress(
            bls_math.sign(self._sk, self._pub, dst=bls_math.DST_POP)
        )

    def pub_key(self) -> BLSPubKey:
        return BLSPubKey(self._pub)


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    """Aggregate individual 96-byte signatures into one (plain G2 sum,
    order-independent). Raises ValueError on any invalid signature —
    aggregation happens at commit materialization, where every input
    already verified."""
    pts = []
    for s in sigs:
        pt = signature_point(bytes(s))
        if pt is None:
            raise ValueError("cannot aggregate invalid BLS signature")
        pts.append(pt)
    if not pts:
        raise ValueError("cannot aggregate zero signatures")
    return bls_math.g2_compress(bls_math.aggregate(pts))


def aggregate_verify(pub_keys: list, msgs: list[bytes], agg_sig: bytes) -> bool:
    """Distinct-message aggregate verification of `agg_sig` (96 bytes)
    over per-signer messages. `pub_keys` are BLSPubKey (or any PubKey:
    a non-BLS key fails verification, never raises). This is the
    crypto-side entry; callers outside crypto/ route through
    crypto/verify_hub.verify_aggregate (the chokepoint)."""
    STATS["aggregate_verifies"] += 1
    STATS["aggregate_signers"] += len(pub_keys)
    if len(pub_keys) != len(msgs) or not pub_keys:
        STATS["aggregate_failures"] += 1
        return False
    if len(agg_sig) != SIGNATURE_SIZE:
        STATS["aggregate_failures"] += 1
        return False
    agg = signature_point(bytes(agg_sig))
    if agg is None:
        STATS["aggregate_failures"] += 1
        return False
    pts = []
    for pk in pub_keys:
        if getattr(pk, "TYPE", None) != KEY_TYPE:
            STATS["aggregate_failures"] += 1
            return False
        pt = pubkey_point(pk.bytes())
        if pt is None:
            STATS["aggregate_failures"] += 1
            return False
        pts.append(pt)
    ok = bls_math.aggregate_verify(pts, [bytes(m) for m in msgs], agg)
    if not ok:
        STATS["aggregate_failures"] += 1
    return ok


register_pubkey_type(KEY_TYPE, BLSPubKey)
