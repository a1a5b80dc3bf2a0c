"""The port's RouterNet (consensus/routernet.py: N consensus nodes, each
behind its own p2p Router over a chaos-wrapped memory transport with a
real ConsensusReactor) against the JAX package's, on the CPU.

- `topology_edges` and `committee_config` equal the reference's.
- The determinism construction (tests/test_routernet.py:315: a frozen
  `ManualClock` behind genesis, 3 equal-power validators, generous
  timeouts, corruption + a one-way partition + clock skew live on the byte
  path) run by both packages: blocks 1-3 and the app-hash chain are
  byte-equal, and both runs hit the same fault classes.
- The wedge dump: a quorum-killing partition wedges the net, and the run
  writes the flight recorder, the fault counters and every node's round
  state to `dump_dir` as a structured outcome, without hanging.
- The chaos-fs crash model end to end: a validator dies with a torn WAL
  tail, restarts on the same stores, repairs the WAL and catches up
  through the reactor's gossip.
- `RouterNet(device=)` puts the hub, the executors and the evidence pools
  on the net's device, and releases the hub on stop.

Every port net runs on device="cpu". Each test bounds its own wall time."""

from __future__ import annotations

import asyncio
import json
import logging
import time
import types

import pytest

import tendermint_tpu.config as j_config
import tendermint_tpu.consensus.harness as j_harness
import tendermint_tpu.consensus.routernet as j_rn
import tendermint_tpu.libs.chaos as j_chaos
import tendermint_tpu.libs.clock as j_clock
import tendermint_tpu_torch.config as p_config
import tendermint_tpu_torch.consensus.harness as p_harness
import tendermint_tpu_torch.consensus.routernet as p_rn
import tendermint_tpu_torch.libs.chaos as p_chaos
import tendermint_tpu_torch.libs.clock as p_clock
from tendermint_tpu_torch.consensus import messages as m
from tendermint_tpu_torch.consensus import scenarios as p_sc
from tendermint_tpu_torch.consensus.ticker import TimeoutInfo
from tendermint_tpu_torch.consensus.types import RoundStep
from tendermint_tpu_torch.crypto import verify_hub as p_vh

MS = 1_000_000

REF = types.SimpleNamespace(rn=j_rn, chaos=j_chaos, clock=j_clock, config=j_config,
                            harness=j_harness, kw={})
PORT = types.SimpleNamespace(rn=p_rn, chaos=p_chaos, clock=p_clock, config=p_config,
                             harness=p_harness, kw={"device": "cpu"})


def generous_config(pkg):
    """tests/test_routernet.py's timeouts: far above the chaos recovery
    latency, so the commit round stays 0."""
    return pkg.config.ConsensusConfig(
        timeout_propose_ns=3000 * MS, timeout_propose_delta_ns=500 * MS,
        timeout_prevote_ns=2000 * MS, timeout_prevote_delta_ns=500 * MS,
        timeout_precommit_ns=2000 * MS, timeout_precommit_delta_ns=500 * MS,
        timeout_commit_ns=80 * MS, skip_timeout_commit=True,
    )


@pytest.mark.parametrize("n,degree,seed", [
    (1, 8, 0), (2, 8, 0), (4, 8, 3), (9, 8, 0), (10, 8, 1), (17, 4, 7), (50, 8, 13),
    (150, 6, 29),
])
def test_topology_edges_equal_the_reference(n, degree, seed):
    got = p_rn.topology_edges(n, degree, seed)
    assert got == j_rn.topology_edges(n, degree, seed)
    if n > 1:  # connected: the ring floor
        assert {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)} <= set(got) \
            or n <= degree + 1


@pytest.mark.parametrize("n", [3, 4, 16, 50, 150])
def test_committee_config_equals_the_reference(n):
    assert vars(p_rn.committee_config(n)) == vars(j_rn.committee_config(n))


async def _determinism_run(pkg, seed: int = 424, target: int = 3):
    """tests/test_routernet.py::test_same_seed_runs_bit_identical_over_real_routers's
    run: block bytes, app hashes, and the fault classes that fired."""
    chaos = pkg.chaos.ChaosNetwork(pkg.chaos.ChaosConfig(
        seed=seed, corrupt_rate=0.015, delay_ms=2.0, clock_skew_ms=80.0))
    net = pkg.rn.RouterNet(
        3, config=generous_config(pkg), chaos=chaos,
        base_clock=pkg.clock.ManualClock(pkg.harness.GENESIS_TIME_NS - 500 * MS),
        stall_refresh_s=0.3, **pkg.kw)
    chaos.partition_oneway({net.nodes[0].node_id}, {net.nodes[1].node_id})
    await net.start()
    try:
        await net.wait_for_height(target, 60)
        assert net.hashes_agree(target)
        return (net.block_fingerprints(target), net.app_hash_chain(target),
                {k for k, v in chaos.faults.items() if v}, chaos.faults["clock_skew"])
    finally:
        await net.stop()


def test_determinism_construction_is_byte_equal_to_the_reference():
    t0 = time.perf_counter()
    ref = asyncio.run(asyncio.wait_for(_determinism_run(REF), 90))
    port = asyncio.run(asyncio.wait_for(_determinism_run(PORT), 90))
    blocks, apps, fired, skews = port
    assert len(blocks) == 3 and all(blocks)
    assert blocks == ref[0], "block bytes differ from the reference's"
    assert apps == ref[1], "app-hash chains differ from the reference's"
    assert {"asym_drop", "corrupt", "clock_skew"} <= fired and skews == 3 == ref[3]
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 60.0


def test_wedge_dump_is_a_structured_outcome(tmp_path, monkeypatch):
    """A partition that leaves no side with a quorum wedges the net: the
    runner reports `wedged` within its stall bound and writes the dump to
    TMTPU_CHAOS_DUMP_DIR (read as the reference reads it, when no
    `dump_dir` is given)."""
    monkeypatch.setenv("TMTPU_CHAOS_DUMP_DIR", str(tmp_path))
    t0 = time.perf_counter()
    probe = p_sc.Scenario(
        "wedge_probe", "quorum-killing split (watchdog self-test)",
        events=(p_sc.Event(0.4, "partition", groups=((0, 1), (2, 3))),),
    )
    res = asyncio.run(asyncio.wait_for(p_sc.run_scenario(
        probe, n_vals=4, target_height=6, seed=5, timeout_s=30.0, stall_s=3.0,
        device="cpu"), 60))
    d = res.as_dict()
    assert d["outcome"] == "wedged" and res.dump_path.startswith(str(tmp_path))
    payload = json.loads(open(res.dump_path).read())
    assert payload["scenario"] == "wedge_probe" and payload["seed"] == 5
    assert payload["faults"]["partition_drop"] > 0
    assert len(payload["nodes"]) == 4 and all("height" in n for n in payload["nodes"])
    assert payload["audit"] is not None and not payload["audit"]["conflicting_commits"]
    assert "flight_dump" in payload
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 30.0


def test_crash_fs_repairs_the_torn_wal_and_catches_up(caplog):
    """RouterNet's crash model (its `crash`/`restart`, a ChaosFS a node):
    node 3 dies with a record in flight in its WAL (written, not fsynced),
    which the crash tears mid-record; it restarts on the same stores and
    WAL dir, repairs the WAL (reported as the reference reports it) and
    catches up through the reactor's gossip."""
    from tendermint_tpu_torch.libs.chaosfs import ChaosFS, ChaosFSConfig

    async def run():
        net = p_rn.RouterNet(
            4, fs_factory=lambda i: ChaosFS(ChaosFSConfig(seed=i, torn_write_rate=1.0)),
            device="cpu")
        await net.start()
        try:
            await net.wait_for_height(2, 30)
            victim = net.nodes[3]
            # a record in flight (written, not fsynced): a stale timeout,
            # which a replay that keeps it whole ignores
            stale = TimeoutInfo(0, 1, 0, RoundStep.NEW_HEIGHT)
            for _ in range(8):
                victim.inner.wal.write(m.encode_wal_message(stale))
            await net.crash(3)
            fs = victim.fs
            torn = dict(fs.faults)
            node = await net.restart(3)
            repaired = list(node.inner.wal.last_repair)
            top = max(net.heights()) + 1
            await net.wait_for_height(top, 30)
            return torn, repaired, net.heights(), net.hashes_agree(top)
        finally:
            await net.stop()

    t0 = time.perf_counter()
    with caplog.at_level(logging.WARNING):
        torn, repaired, heights, agree = asyncio.run(asyncio.wait_for(run(), 90))
    assert torn["torn_write"] == 1 and torn["crash_lost_bytes"] > 0
    assert repaired and repaired[0].valid_end > 0
    assert "WAL repair" in caplog.text  # report_wal_repair on the restart
    assert agree and min(heights) >= 3
    assert p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 45.0


def test_router_net_runs_on_its_device_and_releases_the_hub():
    async def run():
        net = p_rn.RouterNet(4, device="cpu")
        await net.start()
        try:
            hub = p_vh.running_hub()
            await net.wait_for_height(2, 30)
            nodes = net.nodes
            return (hub.device, {n.inner.device for n in nodes},
                    {n.inner.cs.block_exec.device for n in nodes},
                    {n.inner.evidence_pool.device for n in nodes},
                    {n.shell.device for n in nodes},
                    [n.inner.cs.device_error for n in nodes])
        finally:
            await net.stop()

    t0 = time.perf_counter()
    hub_dev, node_devs, exec_devs, ev_devs, shell_devs, err = asyncio.run(
        asyncio.wait_for(run(), 60))
    cpu = p_rn.resolve("cpu")
    assert hub_dev == cpu and node_devs == exec_devs == ev_devs == shell_devs == {cpu}
    assert err == [None] * 4 and p_vh.running_hub() is None
    assert time.perf_counter() - t0 < 30.0
