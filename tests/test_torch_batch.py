"""The port's adaptive batch verifier (tendermint_tpu_torch/crypto/batch.py)
on the CPU: routing by MIN_TPU_BATCH, the Edwards partition (ed25519 and
sr25519 together) against the reference's AdaptiveBatchVerifier, the
measured cutoff, and what happens on a device error — it propagates,
where the reference re-verifies on the host (a difference by design).
Port calls pass device="cpu", where `kernel_eq` runs its plain version.
Inputs come from a numpy seed."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import secp256k1 as jsk
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519 as ped
from tendermint_tpu_torch.crypto import secp256k1 as psk
from tendermint_tpu_torch.crypto import sr25519 as psr
from tendermint_tpu_torch.libs.metrics import RESILIENCE

torch.set_num_threads(1)


def _items(rng, n, mods):
    """n signed (pub, msg, sig) rows per package, alternating ed25519 and
    sr25519 keys; row 3 is signed over another message and row 5 carries
    a signature of the wrong length."""
    ed, sr = mods
    out = []
    for i in range(n):
        seed, msg = rng.bytes(32), rng.bytes(40)
        priv = (ed.Ed25519PrivKey if i % 2 == 0 else sr.Sr25519PrivKey)(seed)
        sig = priv.sign(msg + b"!" if i == 3 else msg)
        out.append((priv.pub_key(), msg, sig[:63] if i == 5 else sig))
    return out


def _verify(bv, items):
    for it in items:
        bv.add(*it)
    return bv.verify()


class _CountingHost(pbatch.CPUBatchVerifier):
    calls = 0

    def verify(self):
        type(self).calls += 1
        return super().verify()


def test_routes_by_min_tpu_batch(monkeypatch):
    """From MIN_TPU_BATCH signatures up a batch goes to the device
    verifier (route "cuda"), below it to the host (route "cpu"), with
    identical verdicts (the patching pattern of tests/test_crypto.py)."""
    rng = np.random.default_rng(1)
    items = _items(rng, 6, (ped, psr))
    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 6)
    monkeypatch.setattr(_CountingHost, "calls", 0)
    monkeypatch.setattr(
        pbatch.AdaptiveBatchVerifier, "_make_device_verifier", lambda self: _CountingHost()
    )
    small = pbatch.create_batch_verifier(items[0][0], "cpu")
    got_small = _verify(small, items[:5])
    assert small.last_route == "cpu" and _CountingHost.calls == 0
    full = pbatch.create_batch_verifier(items[0][0], "cpu")
    got_full = _verify(full, items)
    assert full.last_route == "cuda"
    assert _CountingHost.calls == 1
    assert got_full[1][:5] == got_small[1]
    assert got_full == (False, [True, True, True, False, True, False])


def test_edwards_partition_matches_reference(monkeypatch):
    """ed25519 and sr25519 in one batch through `kernel_eq` (its plain
    version) give the reference's verdicts (its host route, the device
    disabled)."""
    monkeypatch.setenv("TMTPU_DISABLE_TPU", "1")
    ref = _items(np.random.default_rng(2), 8, (jed, jsr))
    port = _items(np.random.default_rng(2), 8, (ped, psr))
    assert [p.bytes() for p, _, _ in port] == [p.bytes() for p, _, _ in ref]
    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 2)
    want_bv = jbatch.create_batch_verifier(ref[0][0])
    want = _verify(want_bv, ref)
    got_bv = pbatch.create_batch_verifier(port[0][0], "cpu", rand_bytes=lambda n: bytes(n))
    got = _verify(got_bv, port)
    assert got == want and want_bv.last_route == "cpu" and got_bv.last_route == "cuda"
    assert got == (False, [True, True, True, False, True, False, True, True])


def test_key_type_support_matches_reference():
    ed = ped.Ed25519PrivKey(b"\x01" * 32).pub_key()
    sr = psr.Sr25519PrivKey(b"\x02" * 32).pub_key()
    sk = psk.Secp256k1PrivKey(b"\x03" * 32).pub_key()
    j_ed = jed.Ed25519PrivKey(b"\x01" * 32).pub_key()
    j_sr = jsr.Sr25519PrivKey(b"\x02" * 32).pub_key()
    j_sk = jsk.Secp256k1PrivKey(b"\x03" * 32).pub_key()
    for p, j in ((ed, j_ed), (sr, j_sr), (sk, j_sk)):
        assert pbatch.supports_batch_verifier(p) == jbatch.supports_batch_verifier(j)
    with pytest.raises(ValueError, match="does not support batch"):
        pbatch.create_batch_verifier(sk, "cpu")
    with pytest.raises(ValueError, match="supports"):
        pbatch.create_batch_verifier(ed, "cpu").add(sk, b"m", bytes(64))
    assert pbatch.create_batch_verifier(ed, "cpu").verify() == (False, [])


class _Crashing(pbatch.CPUBatchVerifier):
    def verify(self):
        raise RuntimeError("simulated kernel failure")


def test_device_error_propagates(monkeypatch):
    """A raising device verifier raises out of AdaptiveBatchVerifier and
    is counted; nothing re-verifies on the host. (The reference's
    AdaptiveBatchVerifier returns the host's verdicts instead, behind its
    breaker: tests/test_verify_hub.py::TestFallbackIdentity.)"""
    rng = np.random.default_rng(3)
    items = _items(rng, 4, (ped, psr))
    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 1)
    monkeypatch.setattr(_CountingHost, "calls", 0)
    monkeypatch.setattr(pbatch, "CPUBatchVerifier", _CountingHost)
    monkeypatch.setattr(
        pbatch.AdaptiveBatchVerifier, "_make_device_verifier", lambda self: _Crashing()
    )
    before = dict(RESILIENCE)
    bv = pbatch.create_batch_verifier(items[0][0], "cpu")
    with pytest.raises(RuntimeError, match="simulated kernel failure"):
        _verify(bv, items)
    assert _CountingHost.calls == 0
    assert RESILIENCE["device_error_batches"] == before["device_error_batches"] + 1
    assert RESILIENCE["device_error_sigs"] == before["device_error_sigs"] + 4


def test_measure_cutoff(monkeypatch):
    """MIN_TPU_BATCH = clamp(device call s × host sigs/s + 1, 8, 2048),
    from one timed device call at the 64 bucket after one warm-up call;
    TMTPU_MIN_TPU_BATCH pins it."""
    import time

    from tendermint_tpu_torch.crypto.cuda import verify as V

    calls = []

    def fake_verify_batch_eq(items, device):
        calls.append((len(items), device))
        time.sleep(0.02)
        return np.ones(len(items), bool)

    monkeypatch.setattr(V, "verify_batch_eq", fake_verify_batch_eq)
    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 32)
    monkeypatch.delenv("TMTPU_MIN_TPU_BATCH", raising=False)
    got = pbatch._measure_cutoff("cpu")
    assert calls == [(64, torch.device("cpu"))] * 2
    assert got["measured"] == int(got["device_call_ms"] / 1e3 * got["host_sigs_per_s"]) + 1
    assert got["device_call_ms"] >= 20
    assert got["min_tpu_batch"] == max(8, min(2048, got["measured"])) == pbatch.MIN_TPU_BATCH
    monkeypatch.setenv("TMTPU_MIN_TPU_BATCH", "77")
    monkeypatch.setattr(pbatch, "MIN_TPU_BATCH", 77)
    assert pbatch._measure_cutoff("cpu") is None and pbatch.MIN_TPU_BATCH == 77
