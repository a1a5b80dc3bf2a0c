"""The port's secp256k1 (tendermint_tpu_torch/crypto/secp256k1.py and the
secp256k1 half of softcrypto.py) against the JAX package's, on the CPU:
keys and addresses, RFC 6979 nonces and signatures byte for byte on the
pure-Python path (OpenSSL's nonces are random on both sides, so there
the signatures are cross-verified instead), the verdicts on tampered
messages and signatures, and commit verification of the mixed ed25519 +
secp256k1 set of BASELINE config 4. Inputs come from a numpy seed."""

from dataclasses import replace as dc_replace

import numpy as np
import pytest
import torch

from tendermint_tpu import testing as jtt
from tendermint_tpu.crypto import secp256k1 as jsk
from tendermint_tpu.crypto import softcrypto as jsoft
from tendermint_tpu.types import validation as jval
from tendermint_tpu_torch import testing as tt
from tendermint_tpu_torch.crypto import secp256k1 as psk
from tendermint_tpu_torch.crypto import softcrypto as psoft
from tendermint_tpu_torch.types import validation as val

torch.set_num_threads(1)

CHAIN_ID = "mixed-chain"


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(4256)


def _secrets(rng, n):
    out = []
    while len(out) < n:
        d = rng.bytes(32)
        if 0 < int.from_bytes(d, "big") < psk.N:
            out.append(d)
    return out


def test_keys_and_addresses_match_reference(rng):
    for d in _secrets(rng, 4):
        p, j = psk.Secp256k1PrivKey(d), jsk.Secp256k1PrivKey(d)
        assert p.pub_key().bytes() == j.pub_key().bytes()
        assert len(p.pub_key().bytes()) == 33
        assert p.pub_key().address() == j.pub_key().address()
        assert psoft.secp256k1_pub(int.from_bytes(d, "big")) == p.pub_key().bytes()


def test_rfc6979_signatures_byte_identical(rng):
    for d in _secrets(rng, 3):
        x = int.from_bytes(d, "big")
        digest = rng.bytes(32)
        assert psoft._rfc6979_k(x, digest) == jsoft._rfc6979_k(x, digest)
        r, s = psoft.secp256k1_sign(x, digest)
        assert (r, s) == jsoft.secp256k1_sign(x, digest)
        pub = psoft.secp256k1_pub(x)
        assert psoft.secp256k1_verify(pub, digest, r, s)
        assert not psoft.secp256k1_verify(pub, bytes(32), r, s)


def test_pure_path_key_signatures_byte_identical(rng, monkeypatch):
    """Both packages' key classes on their pure-Python path: the same
    deterministic, low-S signatures, accepted by OpenSSL as well."""
    monkeypatch.setattr(psk, "_HAVE_OPENSSL", False)
    monkeypatch.setattr(jsk, "_HAVE_OPENSSL", False)
    for d in _secrets(rng, 3):
        msg = rng.bytes(77)
        p, j = psk.Secp256k1PrivKey(d), jsk.Secp256k1PrivKey(d)
        sig = p.sign(msg)
        assert sig == j.sign(msg)
        assert int.from_bytes(sig[32:], "big") <= psk.HALF_N
        assert p.pub_key().verify_signature(msg, sig)
        monkeypatch.setattr(psk, "_HAVE_OPENSSL", True)
        assert p.pub_key().verify_signature(msg, sig)
        monkeypatch.setattr(psk, "_HAVE_OPENSSL", False)


@pytest.mark.parametrize("openssl", [True, False], ids=["openssl", "pure"])
def test_verdicts_match_reference(rng, monkeypatch, openssl):
    monkeypatch.setattr(psk, "_HAVE_OPENSSL", openssl and psk._HAVE_OPENSSL)
    monkeypatch.setattr(jsk, "_HAVE_OPENSSL", openssl and jsk._HAVE_OPENSSL)
    for d in _secrets(rng, 2):
        msg = rng.bytes(50)
        p, j = psk.Secp256k1PrivKey(d), jsk.Secp256k1PrivKey(d)
        sig_p, sig_j = p.sign(msg), j.sign(msg)
        s = int.from_bytes(sig_p[32:], "big")
        high_s = sig_p[:32] + (psk.N - s).to_bytes(32, "big")
        cases = [
            (msg, sig_p), (msg, sig_j), (msg + b"x", sig_p),
            (msg, sig_p[:10] + bytes([sig_p[10] ^ 1]) + sig_p[11:]),
            (msg, sig_p[:40] + bytes([sig_p[40] ^ 1]) + sig_p[41:]),
            (msg, high_s), (msg, sig_p[:63]), (msg, bytes(64)),
        ]
        got = [p.pub_key().verify_signature(m, sg) for m, sg in cases]
        want = [j.pub_key().verify_signature(m, sg) for m, sg in cases]
        assert got == want
        assert got[:3] == [True, True, False] and not any(got[3:])


def test_mixed_validator_set_matches_reference():
    """("ed25519", "secp256k1") alternates key types in creation order,
    as the reference's `key_types` does: same keys, same address order."""
    vals_p, _ = tt.make_validator_set(6, key_types=("ed25519", "secp256k1"))
    vals_j, _ = jtt.make_validator_set(6, key_types=("ed25519", "secp256k1"))
    assert [v.address for v in vals_p.validators] == [v.address for v in vals_j.validators]
    assert [v.pub_key.TYPE for v in vals_p.validators] == [
        v.pub_key.TYPE for v in vals_j.validators
    ]
    assert sorted(v.pub_key.TYPE for v in vals_p.validators) == ["ed25519"] * 3 + ["secp256k1"] * 3


def _outcome(fn):
    try:
        fn()
    except (jval.InvalidCommitError, val.InvalidCommitError) as e:
        return type(e).__name__, str(e), getattr(e, "failed_index", None)
    return None


def _mixed_range(mod, n_vals=4, heights=(1, 2)):
    vals, keys = mod.make_validator_set(n_vals, key_types=("ed25519", "secp256k1"))
    out = []
    for h in heights:
        bid = mod.make_block_id(b"mixed-%d" % h)
        out.append((vals, bid, h, mod.make_commit(CHAIN_ID, h, 0, bid, vals, keys)))
    return out


def _tamper_type(entries, ci, key_type):
    """Flip a bit of the first signature by a `key_type` validator."""
    vals, bid, h, commit = entries[ci]
    vi = next(i for i, v in enumerate(vals.validators) if v.pub_key.TYPE == key_type)
    sigs = list(commit.signatures)
    s = sigs[vi].signature
    sigs[vi] = dc_replace(sigs[vi], signature=s[:7] + bytes([s[7] ^ 0x10]) + s[8:])
    out = list(entries)
    out[ci] = (vals, bid, h, dc_replace(commit, signatures=tuple(sigs)))
    return out


@pytest.mark.parametrize("tampered", [None, "secp256k1", "ed25519"])
def test_mixed_commit_verification_matches_reference(tampered):
    """verify_commit_light and verify_commit_range over the mixed set:
    mixed sets verify signature by signature (they do not batch)."""
    ref, port = _mixed_range(jtt), _mixed_range(tt)
    if tampered:
        ref, port = _tamper_type(ref, 1, tampered), _tamper_type(port, 1, tampered)
    got = [_outcome(lambda: val.verify_commit_range(CHAIN_ID, port, device="cpu"))]
    want = [_outcome(lambda: jval.verify_commit_range(CHAIN_ID, ref))]
    for (pv, pb, ph, pc), (rv, rb, rh, rc) in zip(port, ref):
        got.append(_outcome(lambda: val.verify_commit_light(CHAIN_ID, pv, pb, ph, pc, device="cpu")))
        want.append(_outcome(lambda: jval.verify_commit_light(CHAIN_ID, rv, rb, rh, rc)))
        got.append(_outcome(lambda: val.verify_commit(CHAIN_ID, pv, pb, ph, pc, device="cpu")))
        want.append(_outcome(lambda: jval.verify_commit(CHAIN_ID, rv, rb, rh, rc)))
    assert got == want
    if tampered:
        assert got[0][2] == 1 and "invalid signature at index" in got[0][1]
    else:
        assert got == [None] * 5
