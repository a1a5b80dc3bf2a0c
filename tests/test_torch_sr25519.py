"""The port's sr25519 (tendermint_tpu_torch/crypto/sr25519.py) against the
JAX package's, on the CPU: Keccak-f1600, Strobe-128 and Merlin outputs,
ristretto255 encodings (RFC 9496 small multiples, round trips, rejects),
keys and signatures byte for byte, the host resolution that feeds the
batch equation (`resolve_sr25519`), and the bitmap of `verify_resolved`
on one 64-signature bucket with a tampered entry, where the reference
runs its JAX kernels and the port the kernels' plain versions. Inputs
come from a numpy seed."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_math as jem
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.crypto.tpu import verify as JV
from tendermint_tpu_torch.crypto import ed25519_math as pem
from tendermint_tpu_torch.crypto import sr25519 as psr
from tendermint_tpu_torch.crypto.cuda import verify as V

# the plain versions run on small tensors: one intra-op thread per process
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

RFC9496_SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
    "e882b131016b52c1d3337080187cf768423efccbb517bb495ab812c4160ff44e",
]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20261017)


def _signed(seeds, msgs):
    """(port priv, reference priv, msg, port sig, reference sig) per seed."""
    out = []
    for seed, msg in zip(seeds, msgs):
        p, j = psr.Sr25519PrivKey(seed), jsr.Sr25519PrivKey(seed)
        out.append((p, j, msg, p.sign(msg), j.sign(msg)))
    return out


def test_keccak_f1600_matches_reference(rng):
    for _ in range(4):
        lanes = [int(x) for x in rng.integers(0, 2**63, 25, dtype=np.uint64) * 2 + 1]
        assert psr.keccak_f1600(list(lanes)) == jsr.keccak_f1600(list(lanes))


@pytest.mark.parametrize("length", [0, 1, 165, 166, 167, 500])
def test_strobe_and_merlin_match_reference(rng, length):
    """Messages on both sides of Strobe's 166-byte rate (a permutation
    inside `_absorb`)."""
    label, msg = rng.bytes(7), rng.bytes(length)
    s_p, s_j = psr.Strobe128(label), jsr.Strobe128(label)
    s_p.ad(msg, False)
    s_j.ad(msg, False)
    assert s_p.prf(64) == s_j.prf(64)
    assert bytes(s_p.state) == bytes(s_j.state)

    t_p, t_j = psr.MerlinTranscript(label), jsr.MerlinTranscript(label)
    for t in (t_p, t_j):
        t.append_message(b"m", msg)
    c_p, c_j = t_p.copy(), t_j.copy()
    assert t_p.challenge_bytes(b"c", 200) == t_j.challenge_bytes(b"c", 200)
    assert c_p.challenge_scalar(b"s") == c_j.challenge_scalar(b"s")
    pub, r = rng.bytes(32), rng.bytes(32)
    assert psr.transcript_challenge(msg, pub, r) == jsr.transcript_challenge(msg, pub, r)


def test_ristretto_matches_reference(rng):
    for k, want in enumerate(RFC9496_SMALL_MULTIPLES):
        p = pem.Point.identity() if k == 0 else pem.BASE.scalar_mul(k)
        assert psr.ristretto_encode(p).hex() == want
    for k in [int.from_bytes(rng.bytes(32), "little") % pem.L for _ in range(6)]:
        enc = psr.ristretto_encode(pem.BASE.scalar_mul(k))
        assert enc == jsr.ristretto_encode(jem.BASE.scalar_mul(k))
        got, want = psr.ristretto_decode(enc), jsr.ristretto_decode(enc)
        assert (got.X, got.Y, got.Z, got.T) == (want.X, want.Y, want.Z, want.T)
        assert psr.ristretto_encode(got) == enc
        assert got.compress() == want.compress()
    # rejects: non-canonical, negative, random bytes, wrong length
    rejects = [(psr.P + 3).to_bytes(32, "little"), (3).to_bytes(32, "little"), b"\x01" * 31]
    rejects += [rng.bytes(32) for _ in range(8)]
    for enc in rejects:
        got, want = psr.ristretto_decode(enc), jsr.ristretto_decode(enc)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.compress() == want.compress()
    assert all(psr.ristretto_decode(e) is None for e in rejects[:3])


def test_keys_and_signatures_byte_identical(rng):
    seeds = [rng.bytes(32) for _ in range(4)]
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 300, 4)]
    for p, j, msg, sig_p, sig_j in _signed(seeds, msgs):
        assert p.pub_key().bytes() == j.pub_key().bytes()
        assert p.pub_key().address() == j.pub_key().address()
        assert sig_p == sig_j
        assert p.pub_key().verify_signature(msg, sig_p)
        for i in (0, 31, 32, 62, 63):
            bad = bytearray(sig_p)
            bad[i] ^= 0x04
            assert p.pub_key().verify_signature(msg, bytes(bad)) == j.pub_key().verify_signature(
                msg, bytes(bad)
            )
        assert not p.pub_key().verify_signature(msg + b"x", sig_p)


def _resolve_cases(rng):
    """(pub, msg, sig) rows: valid, wrong message, no schnorrkel marker,
    s ≥ L, and an R that is no ristretto encoding."""
    seeds = [rng.bytes(32) for _ in range(3)]
    msgs = [rng.bytes(40) for _ in range(3)]
    rows = []
    for p, _j, msg, sig, _ in _signed(seeds, msgs):
        pub = p.pub_key().bytes()
        rows.append((pub, msg, sig))
        rows.append((pub, msg + b"!", sig))
    pub, msg, sig = rows[0]
    rows.append((pub, msg, sig[:63] + bytes([sig[63] & 0x7F])))
    big_s = bytearray((psr.L + 5).to_bytes(32, "little"))
    big_s[31] |= 0x80
    rows.append((pub, msg, sig[:32] + bytes(big_s)))
    rows.append((pub, msg, (3).to_bytes(32, "little") + sig[32:]))
    return rows


def test_resolve_sr25519_matches_reference(rng):
    rows = _resolve_cases(rng)
    nones = 0
    for pub, msg, sig in rows:
        got, want = V.resolve_sr25519(pub, msg, sig), JV.resolve_sr25519(pub, msg, sig)
        if want is None:
            assert got is None
            nones += 1
            continue
        assert (got.a, got.r, got.s, got.k) == (want.a, want.r, want.s, want.k)
    assert nones == 3


def test_verify_resolved_bitmap_matches_reference(rng):
    """One 64-signature bucket of sr25519 and ed25519 entries together
    (the two key types share the equation), one sr25519 entry signed over
    another message and one malformed: the reference's JAX kernels and
    the port's plain versions give the same bitmap."""
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    seeds = [rng.bytes(32) for _ in range(6)]
    msgs = [rng.bytes(48) for _ in range(6)]
    rows = [(p.pub_key().bytes(), msg, sig) for p, _j, msg, sig, _ in _signed(seeds, msgs)]
    pub, msg, sig = rows[2]
    rows[2] = (pub, msg + b"tampered", sig)
    rows[4] = (rows[4][0], rows[4][1], rows[4][2][:63] + bytes([rows[4][2][63] & 0x7F]))
    ed = [Ed25519PrivKey(rng.bytes(32)) for _ in range(3)]
    ed_rows = [(k.pub_key().bytes(), m, k.sign(m)) for k, m in zip(ed, msgs)]

    def entries(mod):
        return [mod.resolve_sr25519(*r) for r in rows] + [mod.resolve_ed25519(*r) for r in ed_rows]

    want = np.asarray(JV.verify_resolved(entries(JV)))
    got = V.verify_resolved(entries(V), "cpu")
    assert got.tolist() == want.tolist()
    assert got.tolist() == [True, True, False, True, False, True, True, True, True]


def test_device_batch_verifier_sends_sr25519_to_the_equation(rng):
    """sr25519 keys are resolved for `kernel_eq`, not verified on the
    host (the reference's TPUBatchVerifier does the same)."""
    (p, _j, msg, sig, _), = _signed([rng.bytes(32)], [b"m"])
    bv = V.DeviceBatchVerifier("cpu")
    bv.add(p.pub_key(), msg, sig)
    assert not bv._host_items
    e, want = bv._entries[0], JV.resolve(p.pub_key(), msg, sig)
    assert (e.a, e.r, e.s, e.k) == (want.a, want.r, want.s, want.k)
