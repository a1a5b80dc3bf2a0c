"""The port's scenario engine (consensus/scenarios.py) against the JAX
package's, on the CPU.

- The registry equals the reference's: the same 17 scenarios in the same
  order, with the same chaos and chaos-fs configs, event scripts,
  Byzantine plans and audit settings (the summaries are prose, compared
  only for being there).
- Every scenario runs `ok` at 4 validators with bench.py's small-row
  parameters (bench.py:615-640: target 3, seed 7, stall 25 s; the
  parameters chip_smoke.py's phase 27 runs on the card), with a green
  audit; `run_sweep` returns one structured result per name.
- The two lifecycles: `run_boot_wave(n_vals=4, n_joiners=2)` (both
  joiners statesync into the live committee, honest chain) and
  `run_light_attack(n_vals=3)` (the lunatic fork is detected and its
  evidence committed within K heights) are `ok`.
- Every entry point raises without a card unless device="cpu" is given,
  and a DeviceError inside a run propagates out of `run_scenario` (after
  the net is stopped and the hub released) instead of being reported as
  `wedged`.

Each test bounds its own wall time."""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import time

import pytest
import torch

import tendermint_tpu.consensus.scenarios as j_sc
from tendermint_tpu_torch.consensus import routernet as p_rn
from tendermint_tpu_torch.consensus import scenarios as p_sc
from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.crypto import verify_hub as p_vh
from tendermint_tpu_torch.crypto.batch import DeviceError
from tendermint_tpu_torch.crypto.cuda import field as p_field

#: bench.py's chaos_soak small rows (bench.py:615-640)
SOAK = dict(n_vals=4, target_height=3, seed=7, timeout_s=75.0, stall_s=25.0,
            time_scale=1.0, degree=8)


def _plain(x):
    """A scenario as plain data: dataclasses as (class name, fields),
    enums as ints, so both packages' registries compare; a summary only
    as whether there is one."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple((f.name, bool(getattr(x, f.name)) if f.name == "summary"
                       else _plain(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, dict):
        return tuple(sorted((k, _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def test_registry_has_the_references_names_in_order():
    assert list(p_sc.SCENARIOS) == list(j_sc.SCENARIOS)
    assert len(p_sc.SCENARIOS) == 17


@pytest.mark.parametrize("name", list(j_sc.SCENARIOS))
def test_scenario_equals_the_reference(name):
    assert _plain(p_sc.SCENARIOS[name]) == _plain(j_sc.SCENARIOS[name])


@pytest.mark.parametrize("name", list(j_sc.SCENARIOS))
def test_every_scenario_runs_ok_at_four_validators(name):
    t0 = time.perf_counter()
    res = asyncio.run(asyncio.wait_for(p_sc.run_scenario(name, device="cpu", **SOAK), 120))
    d = res.as_dict()
    assert d["outcome"] == "ok", d
    assert d["audit"]["ok"], d["audit"]
    assert d["blocks_per_s"] > 0 and not d["error"]
    scen = p_sc.SCENARIOS[name]
    if scen.events:
        assert d["recover_s"] is not None
        assert len(d["events_applied"]) == len(scen.events)
    if scen.chaos.enabled():
        assert any(d["faults"].values()), d["faults"]
    if scen.byz or scen.byz_f_max:
        assert d["byz_indices"] and d["byz_actions"]
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 30.0


def test_run_sweep_returns_one_structured_result_per_name():
    t0 = time.perf_counter()
    res = asyncio.run(asyncio.wait_for(p_sc.run_sweep(
        ["baseline", "clock_skew"], device="cpu", **SOAK), 120))
    assert [r.scenario for r in res] == ["baseline", "clock_skew"]
    assert all(r.ok for r in res)
    assert res[1].faults["clock_skew"] == 4
    assert time.perf_counter() - t0 < 20.0


def test_boot_wave_joins_two_nodes_into_a_live_committee():
    t0 = time.perf_counter()
    out = asyncio.run(asyncio.wait_for(
        p_sc.run_boot_wave(n_vals=4, n_joiners=2, device="cpu"), 150))
    assert out["outcome"] == "ok", out
    assert out["joined"] == 2 and out["honest_chain_ok"] and not out["join_errors"]
    assert out["chunks_served"] > 0 and out["backfill_sigs"] > 0
    assert all(h >= 10 for h in out["joiner_heights"])  # the snapshot at 10
    assert out["audit"]["ok"]
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 30.0


def test_light_attack_is_detected_and_its_evidence_committed():
    t0 = time.perf_counter()
    out = asyncio.run(asyncio.wait_for(p_sc.run_light_attack(n_vals=3, device="cpu"), 150))
    assert out["outcome"] == "ok", out
    assert out["divergence_detected"] and out["served_forged"] > 0
    assert out["time_to_lca_commit_heights"] is not None
    assert out["time_to_lca_commit_heights"] <= 3
    assert out["lca_evidence_hex"] and len(out["traitors"]) == 2
    assert out["audit"]["ok"] and not out["audit"]["missing_lca"]
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 30.0


ENTRY_POINTS = {
    "run_scenario": lambda **kw: asyncio.run(p_sc.run_scenario("baseline", **kw)),
    "run_sweep": lambda **kw: asyncio.run(p_sc.run_sweep(["baseline"], **kw)),
    "run_light_attack": lambda **kw: asyncio.run(p_sc.run_light_attack(**kw)),
    "run_boot_wave": lambda **kw: asyncio.run(p_sc.run_boot_wave(**kw)),
    "RouterNet": lambda **kw: p_rn.RouterNet(4, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda_unless_cpu_requested(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    fn = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    assert p_vh.running_hub() is None
    if name == "RouterNet":
        assert fn(device="cpu").device == torch.device("cpu")


def test_a_device_error_propagates_out_of_run_scenario(monkeypatch):
    """A failing card (the plain B2 raising under a lowered cutoff, as in
    tests/test_torch_device_errors.py) stops the height-2 proposer's
    machine in its LastCommit check; the runner raises the DeviceError,
    never a `wedged` outcome. (Without a hub: a hub verifies a lone vote
    on the host and answers the commit's signatures from its verdict
    cache, so at 4 validators nothing would reach the card.)"""
    def fail(z):
        raise ValueError("field.pow22523: operand on the wrong device")

    monkeypatch.setattr(p_batch, "MIN_TPU_BATCH", 1)
    monkeypatch.setattr(p_field, "_pow22523_plain", fail)
    t0 = time.perf_counter()
    with pytest.raises(DeviceError, match="wrong device"):
        asyncio.run(asyncio.wait_for(p_sc.run_scenario(
            "lossy_links", n_vals=4, target_height=3, seed=7, timeout_s=60.0,
            stall_s=20.0, use_hub=False, device="cpu"), 90))
    assert time.perf_counter() - t0 < 20.0, "the runner waited for its stall bound"
    assert p_vh.running_hub() is None
