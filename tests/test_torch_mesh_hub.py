"""The mesh half of the sharded verifier on the CPU: the VerifyHub's
capacity and window scaled by the mesh size, its stats and dispatch
spans, and the device registry (crypto/cuda/mesh.py) — the counterparts
of tests/test_mesh_hub.py's hub and registry cases, with the reference's
`mesh_scale` knob. The port reads no TMTPU_MESH_SCALE env, has no
breaker, probe or degrade, and a hub on the CPU never reads CUDA."""

import logging
import secrets

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as B
from tendermint_tpu_torch.crypto import ed25519
from tendermint_tpu_torch.crypto import verify_hub as vh
from tendermint_tpu_torch.crypto.cuda import mesh
from tendermint_tpu_torch.crypto.cuda import verify as V
from tendermint_tpu_torch.crypto.verify_hub import VerifyHub
from tendermint_tpu_torch.libs import trace

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh.reset()
    yield
    mesh.reset()


def _items(n, tag=b"mesh"):
    out = []
    for i in range(n):
        priv = ed25519.Ed25519PrivKey(secrets.token_bytes(32))
        msg = tag + b"-%d" % i
        out.append((priv.pub_key(), msg, priv.sign(msg)))
    return out


def test_hub_scales_capacity_by_mesh(monkeypatch):
    """max_batch is per device: the pack capacity and the adaptive-window
    ramp scale with the mesh size, and shrink back when it does."""
    hub = VerifyHub(device="cpu", max_batch=16, window_ms=4.0, cache_size=0)
    monkeypatch.setattr(B, "mesh_parallelism", lambda device: 8)
    assert hub._refresh_mesh() == 8
    assert hub._effective_max() == 128
    ceiling = hub.window_s  # unchanged by the mesh
    hub._ewma_occupancy = 9.0  # full-window occupancy for one device
    w_mesh = hub._window()
    monkeypatch.setattr(B, "mesh_parallelism", lambda device: 1)
    hub._refresh_mesh()
    assert hub._effective_max() == 16
    w_single = hub._window()
    assert w_single == ceiling
    assert w_mesh == pytest.approx(ceiling * (9.0 - 1.0) / (128 / 8.0))
    assert w_mesh < w_single
    monkeypatch.setattr(B, "mesh_parallelism", lambda device: 5)
    assert hub._refresh_mesh() == 5 and hub._effective_max() == 80


def test_hub_mesh_scale_knob(monkeypatch):
    """`mesh_scale` (constructor and VerifyHubConfig) as the reference's
    hub has it: on, the capacity is max_batch per device of the mesh; off,
    it is max_batch whatever the mesh. The port reads no TMTPU_MESH_SCALE
    env (the reference's override waits for the cli port): with it set to
    0, the port's default still scales, the reference's does not."""
    import dataclasses

    from tendermint_tpu import config as j_config
    from tendermint_tpu.crypto import batch as j_batch
    from tendermint_tpu.crypto import verify_hub as j_vh
    from tendermint_tpu_torch.config import VerifyHubConfig

    monkeypatch.setattr(B, "mesh_parallelism", lambda device: 8)
    monkeypatch.setattr(j_batch, "mesh_parallelism", lambda: 8)
    for knob in (True, False, None):
        hub = VerifyHub(device="cpu", max_batch=16, mesh_scale=knob)
        ref = j_vh.VerifyHub(max_batch=16, mesh_scale=knob)
        assert hub.mesh_scale == ref.mesh_scale == (knob is not False)
        assert hub._refresh_mesh() == ref._refresh_mesh() == (1 if knob is False else 8)
        assert hub._effective_max() == ref._effective_max() == (16 if knob is False else 128)
    fields = {f.name: f.default for f in dataclasses.fields(VerifyHubConfig)}
    ref_fields = {f.name: f.default for f in dataclasses.fields(j_config.VerifyHubConfig)}
    assert fields == ref_fields
    assert (fields["enabled"], fields["mesh_scale"]) == (True, True)

    monkeypatch.setenv("TMTPU_MESH_SCALE", "0")
    hub = VerifyHub(device="cpu", max_batch=16)
    assert hub._refresh_mesh() == 8 and hub._effective_max() == 128
    ref = j_vh.VerifyHub(max_batch=16)
    assert ref.mesh_scale is False and ref._refresh_mesh() == 1


def test_hub_stats_carry_mesh_fields(monkeypatch):
    monkeypatch.setattr(B, "mesh_parallelism", lambda device: 4)
    hub = VerifyHub(device="cpu", max_batch=32)
    hub._refresh_mesh()
    s = hub.stats()
    assert s["mesh_devices"] == 4.0 and s["effective_max_batch"] == 128.0


def test_mesh_max_devices_cap(monkeypatch, caplog):
    """TMTPU_MESH_MAX_DEVICES caps the mesh at enumeration, which logs the
    devices visible and the devices spanned (a card count of 8 stood in);
    a cap of 1 pins one device, the port's only switch for that (the
    reference's TMTPU_NO_SHARDED is not read)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("TMTPU_MESH_MAX_DEVICES", "2")
    with caplog.at_level(logging.INFO, logger="crypto.mesh"):
        assert mesh.active_count() == 2
        assert mesh.device_list() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert [r.getMessage() for r in caplog.records] == [
        "device mesh: 8 device(s) visible, 2 in the mesh"
    ]
    assert V._shard_device_count(torch.device("cuda")) == 2
    assert V._shard_device_count(CPU) == 1  # a CPU caller never takes CUDA shards
    monkeypatch.setenv("TMTPU_NO_SHARDED", "1")
    assert V._shard_device_count(torch.device("cuda")) == 2
    monkeypatch.setenv("TMTPU_MESH_MAX_DEVICES", "1")
    mesh.reset()
    assert V._shard_device_count(torch.device("cuda")) == 1
    assert V._select_kernels(8192, torch.device("cuda")).devices is None


def test_hub_dispatch_span_carries_shards(monkeypatch):
    """The hub stamps devices and shards from its verifier's last sharded
    dispatch onto the hub.dispatch span."""

    class FakeBV:
        last_route = "cuda"
        last_dispatch = {"devices": ["cuda:0", "cuda:0"], "shards": [5, 3]}

        def __init__(self):
            self._items = []

        def add(self, pk, msg, sig):
            self._items.append((pk, msg, sig))

        def verify(self):
            return True, [True] * len(self._items)

    monkeypatch.setattr(vh, "create_batch_verifier", lambda pk, device: FakeBV())
    monkeypatch.setattr(trace.RECORDER, "enabled", True)
    trace.RECORDER.clear()
    hub = VerifyHub(device="cpu", max_batch=8, window_ms=0.5, cache_size=0)
    hub.start()
    try:
        assert all(hub.verify_many(_items(4, b"span"), timeout=30.0))
    finally:
        hub.stop()
    spans = [s for s in trace.RECORDER.dump(subsystem="hub") if s["name"] == "dispatch"]
    assert spans, "no hub.dispatch span recorded"
    attrs = spans[-1]["attrs"]
    assert attrs["devices"] == ["cuda:0", "cuda:0"] and attrs["shards"] == [5, 3]
    assert attrs["route"] == "cuda"


def test_hub_dispatch_runs_sharded_over_logical_cpu_shards(monkeypatch):
    """A CPU hub over two logical CPU shards packs 2 x max_batch and its
    batch runs the sharded kernels: the verdicts are right, the span and
    the verifier carry the shards."""
    monkeypatch.setattr(mesh, "_devices", [CPU] * 2)
    monkeypatch.setattr(B, "MIN_TPU_BATCH", 8)
    monkeypatch.setenv("TMTPU_FORCE_SHARDED", "1")
    monkeypatch.setattr(trace.RECORDER, "enabled", True)
    trace.RECORDER.clear()
    items = _items(16, b"shard")
    pub, msg, sig = items[9]
    items[9] = (pub, msg, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
    hub = VerifyHub(device="cpu", max_batch=8, window_ms=50.0, cache_size=0)
    hub.start()
    try:
        out = hub.verify_many(items, timeout=120.0)
        stats = hub.stats()
    finally:
        hub.stop()
    assert out == [i != 9 for i in range(16)]
    assert stats["mesh_devices"] == 2.0 and stats["effective_max_batch"] == 16.0
    assert stats["dispatches"] == 1.0
    (span,) = [s for s in trace.RECORDER.dump(subsystem="hub") if s["name"] == "dispatch"]
    assert span["attrs"] == {"sigs": 16, "route": "cuda", "devices": ["cpu", "cpu"],
                             "shards": [16, 0]}


def test_device_list_is_empty_without_cuda(monkeypatch):
    """On a machine without CUDA the mesh is empty (and not cached), so a
    dispatch stays on one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.device_list() == [] and mesh.active_count() == 0 and mesh._devices is None
    assert B.mesh_parallelism("cpu") == 1
    assert V._select_kernels(8192, CPU).devices is None


def test_a_cpu_hub_never_reads_cuda(monkeypatch):
    """A hub on the CPU reads only logical CPU shards set by hand: it
    never asks torch about CUDA, whatever it dispatches."""

    def no_cuda(*_a):
        raise AssertionError("a CPU hub read CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    hub = VerifyHub(device="cpu", max_batch=8, window_ms=0.5)
    hub.start()
    try:
        assert hub.verify_many(_items(3, b"cpu-hub"), timeout=30.0) == [True] * 3
        assert hub.stats()["mesh_devices"] == 1.0
        monkeypatch.setattr(mesh, "_devices", [CPU] * 4)
        assert hub._refresh_mesh() == 4 and hub._effective_max() == 32
    finally:
        hub.stop()
