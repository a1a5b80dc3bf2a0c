"""The reference's env knobs that the port reads as it does, each in a
fresh interpreter. Two are read once, at import: TMTPU_MIN_HASH_BATCH
sets `crypto.hash_hub.MIN_DEVICE_BATCH` and TMTPU_MAX_BUCKET sets
`crypto.cuda.verify._MAX_BUCKET` (the reference's
`crypto/tpu/verify._MAX_BUCKET`), with the reference's defaults when
unset. Two steer the sharded verifier, read with the knob set and then
unset in one interpreter: TMTPU_MESH_MAX_DEVICES caps the mesh at
enumeration (the port's CUDA count stood in by 8, the reference's 8
virtual devices) and TMTPU_FORCE_SHARDED drops the size gate at each
call (the port on 8 logical CPU shards). The sidecar's, the tx
ingress's and consensus's knobs (TMTPU_VERIFYD_*, TMTPU_INGRESS_*,
TMTPU_INGEST_* and TMTPU_COMMIT_SCHEME) are read when their object is
built or at each commit, each set (over an explicit argument or config
value, where there is one) and unset, all in one fresh interpreter per
package. In that interpreter TMTPU_WIREGEN=0, then unset, is read by the
reference's message codec at (re)import; the port does not read it: its
only codec is the interpreted one until the generator is ported. The
full node's knobs (TMTPU_VERIFYHUB_DISABLE, TMTPU_INGRESS_DISABLE,
TMTPU_CATCHUP_RATE, read when a Node starts, and TMTPU_TRACE_DIR, read
when the flight recorder is configured) are each set and unset around a
one-validator Node's start, in one fresh interpreter per package. The
chaos knobs (TMTPU_CHAOS_* and TMTPU_CHAOS_FS_*) are read at each
`ChaosConfig.from_env()` / `ChaosFSConfig.from_env()` call, each set alone
and read in both packages in this interpreter; a Node reads them through
those calls (tests/test_torch_node.py::test_unported_settings_raise), and
the scenario runner reads TMTPU_CHAOS_DUMP_DIR
(tests/test_torch_routernet.py::test_wedge_dump_is_a_structured_outcome)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

KNOBS = {
    "TMTPU_MIN_HASH_BATCH": (
        "tendermint_tpu.crypto.hash_hub", "tendermint_tpu_torch.crypto.hash_hub",
        "MIN_DEVICE_BATCH",
    ),
    "TMTPU_MAX_BUCKET": (
        "tendermint_tpu.crypto.tpu.verify", "tendermint_tpu_torch.crypto.cuda.verify",
        "_MAX_BUCKET",
    ),
}


def _values(knob: str, value: str | None) -> tuple[int, int]:
    """(reference's value, port's value) of `knob`'s variable, imported in
    a fresh interpreter with the knob set to `value` (unset: None)."""
    ref_mod, port_mod, attr = KNOBS[knob]
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(JAX_PLATFORMS="cpu", TMTPU_DISABLE_TPU="1")
    if value is not None:
        env[knob] = value
    code = (
        "import importlib, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"ref = importlib.import_module({ref_mod!r})\n"
        f"port = importlib.import_module({port_mod!r})\n"
        f"print(ref.{attr}, port.{attr})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    ref, port = out.stdout.split()[-2:]
    return int(ref), int(port)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_port_reads_the_knob_as_the_reference_does(knob):
    set_ = _values(knob, "96")
    assert set_[1] == set_[0] == 96
    default = _values(knob, None)
    assert default[1] == default[0] == {"TMTPU_MIN_HASH_BATCH": 256, "TMTPU_MAX_BUCKET": 8192}[knob]


#: knobs read at each call: (the value set, setup, the reference's and
#: the port's reading, what both read set and unset)
CALL_KNOBS = {
    "TMTPU_MESH_MAX_DEVICES": (
        "2",
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 8\n",
        "jmesh.active_count(), mesh.active_count()",
        [[2, 2], [8, 8]],
    ),
    "TMTPU_FORCE_SHARDED": (
        "1",
        "mesh._devices = [cpu] * 8\n",
        "len(JV._select_kernels(1, 1).devices or []), len(V._select_kernels(1, cpu).devices or [])",
        [[8, 8], [0, 0]],
    ),
}


@pytest.mark.parametrize("knob", sorted(CALL_KNOBS))
def test_port_reads_the_mesh_knob_as_the_reference_does(knob):
    value, setup, read, want = CALL_KNOBS[knob]
    env = {k: v for k, v in os.environ.items() if k not in CALL_KNOBS}
    env.update(JAX_PLATFORMS="cpu", TMTPU_DISABLE_TPU="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (
        "import json, os, jax, torch\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from tendermint_tpu.crypto.tpu import mesh as jmesh, verify as JV\n"
        "from tendermint_tpu_torch.crypto.cuda import mesh, verify as V\n"
        "cpu = torch.device('cpu')\n"
        "out = []\n"
        f"for value in ({value!r}, None):\n"
        f"    os.environ.pop({knob!r}, None) if value is None else os.environ.update({{{knob!r}: value}})\n"
        "    jmesh.reset()\n"
        "    mesh.reset()\n"
        + "".join(f"    {line}\n" for line in setup.splitlines())
        + f"    out.append([{read}])\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == want


#: knobs read when an object is built: the value set, and how each
#: package builds the object and reads the knob's field (`pkg` is the
#: package's name; `dev` the port's device argument, empty for the
#: reference)
BUILD_KNOBS = {
    "TMTPU_VERIFYD_TIMEOUT": ("7.5", "vd.VerifydClient('/nonexistent').io_timeout"),
    "TMTPU_VERIFYD_BREAKER_THRESHOLD": (
        "4", "vd.VerifydClient('/nonexistent').breaker.failure_threshold"),
    "TMTPU_VERIFYD_BREAKER_RESET": ("0.25", "vd.VerifydClient('/nonexistent').breaker.reset_timeout"),
    "TMTPU_VERIFYD_INFLIGHT": ("77", "vd.VerifyDaemon('/nonexistent', max_inflight=5, **dev).max_inflight"),
    "TMTPU_VERIFYD_SOCK": ("/tmp/x.sock", "vh.VerifyHub(verifyd_sock='/explicit', **dev).verifyd_sock"),
    "TMTPU_INGRESS_DEPTH": ("33", "ingress().depth"),
    "TMTPU_INGRESS_WORKERS": ("5", "ingress().verify_workers"),
    "TMTPU_INGRESS_LANE_DEPTH": ("6", "ingress().lane_depth"),
    "TMTPU_INGRESS_PARK_MS": ("12.5", "ingress().park_timeout_ns"),
    "TMTPU_INGRESS_CHECKTX_BATCH": ("9", "ingress().checktx_batch"),
    "TMTPU_INGEST_PIPELINE": ("0", "consensus().ingest is not None"),
    "TMTPU_INGEST_INFLIGHT": ("17", "consensus().ingest.max_inflight"),
    "TMTPU_COMMIT_SCHEME": ("bls-aggregate", "aggregated()"),
    "TMTPU_WIREGEN": ("0", "importlib.reload(cs_msgs).wiregen_active()"),
}


def _build_knob_readings(pkg: str) -> dict:
    dev = "{'device': 'cpu'}" if pkg == "tendermint_tpu_torch" else "{}"
    env = {k: v for k, v in os.environ.items() if k not in BUILD_KNOBS}
    env.update(JAX_PLATFORMS="cpu", TMTPU_DISABLE_TPU="1")
    code = (
        "import json, os\n"
        + ("import jax\njax.config.update('jax_platforms', 'cpu')\n" if pkg == "tendermint_tpu" else "")
        + f"from {pkg}.crypto import verifyd as vd, verify_hub as vh\n"
        f"from {pkg}.abci.application import BaseApplication\n"
        f"from {pkg}.abci.client import LocalClient\n"
        f"from {pkg}.config import MempoolConfig\n"
        f"from {pkg}.mempool.ingress import TxIngress\n"
        f"from {pkg}.mempool.pool import PriorityMempool\n"
        f"dev = {dev}\n"
        "def ingress():\n"
        "    cfg = MempoolConfig()\n"
        "    return TxIngress(cfg.ingress, PriorityMempool(cfg, LocalClient(BaseApplication())))\n"
        "import asyncio, importlib, tempfile\n"
        f"from {pkg}.consensus import harness, messages as cs_msgs\n"
        f"from {pkg}.types.keys import SignedMsgType\n"
        f"from {pkg}.types.vote_set import VoteSet\n"
        f"from {pkg}.testing import make_block_id, make_vote\n"
        "tmp = tempfile.TemporaryDirectory()\n"
        "bls_genesis, bls_keys = harness.make_genesis(1, key_type='bls12381')\n"
        "def consensus(genesis=None):\n"
        "    node = harness.Node(genesis or harness.make_genesis(1)[0], None,\n"
        "                        wal_dir=tempfile.mkdtemp(dir=tmp.name), **dev)\n"
        "    asyncio.run(node.start(start_consensus=False))\n"
        "    return node.cs\n"
        "def aggregated():\n"
        "    cs = consensus(bls_genesis)\n"
        "    vals = cs.rs.validators\n"
        "    vs = VoteSet(bls_genesis.chain_id, 1, 0, SignedMsgType.PRECOMMIT, vals)\n"
        "    vs.add_vote(make_vote(bls_genesis.chain_id, bls_keys[0], 0, 1, 0,\n"
        "                          SignedMsgType.PRECOMMIT, make_block_id()))\n"
        "    return cs._materialize_commit(vs).is_aggregate()\n"
        "out = {}\n"
        f"for knob, (value, read) in {BUILD_KNOBS!r}.items():\n"
        "    os.environ[knob] = value\n"
        "    got_set = eval(read)\n"
        "    del os.environ[knob]\n"
        "    out[knob] = [got_set, eval(read)]\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_port_reads_the_sidecar_and_ingress_knobs_as_the_reference_does():
    ref = _build_knob_readings("tendermint_tpu")
    port = _build_knob_readings("tendermint_tpu_torch")
    # a difference by design: the port's codec is the interpreted one
    # whatever TMTPU_WIREGEN says
    assert ref.pop("TMTPU_WIREGEN") == [False, True]
    assert port.pop("TMTPU_WIREGEN") == [False, False]
    assert port == ref
    assert port["TMTPU_INGEST_PIPELINE"] == [False, True]
    assert port["TMTPU_INGEST_INFLIGHT"] == [17, 64]
    assert port["TMTPU_COMMIT_SCHEME"] == [True, False]
    assert port["TMTPU_VERIFYD_TIMEOUT"] == [7.5, 60.0]
    assert port["TMTPU_VERIFYD_INFLIGHT"] == [77, 5]
    assert port["TMTPU_VERIFYD_SOCK"] == ["/tmp/x.sock", "/explicit"]
    assert port["TMTPU_INGRESS_PARK_MS"] == [12_500_000, 3_000_000_000]
    assert port["TMTPU_INGRESS_DEPTH"] == [33, 2048]


#: the full node's knobs: the value set, and what a started Node (`node`)
#: or the flight recorder (`trace`) reads
NODE_KNOBS = {
    "TMTPU_VERIFYHUB_DISABLE": ("1", "node.verify_hub is None"),
    "TMTPU_INGRESS_DISABLE": ("true", "node.ingress is None"),
    "TMTPU_CATCHUP_RATE": ("250", "node.cs_reactor.catchup_rate"),
    "TMTPU_TRACE_DIR": ("/tmp/flight", "trace.configure(out_dir='/cfg').out_dir"),
}


def _node_knob_readings(pkg: str) -> dict:
    dev = "{'device': 'cpu'}" if pkg == "tendermint_tpu_torch" else "{}"
    env = {k: v for k, v in os.environ.items() if k not in NODE_KNOBS}
    env.update(JAX_PLATFORMS="cpu", TMTPU_DISABLE_TPU="1")
    code = (
        "import asyncio, json, os, shutil\n"
        + ("import jax\njax.config.update('jax_platforms', 'cpu')\n" if pkg == "tendermint_tpu" else "")
        + f"from {pkg}.abci.kvstore import KVStoreApp\n"
        f"from {pkg}.consensus import harness\n"
        f"from {pkg}.crypto import ed25519\n"
        f"from {pkg}.libs import trace\n"
        f"from {pkg}.node import Node, NodeConfig\n"
        f"from {pkg}.p2p.memory import MemoryNetwork\n"
        f"dev = {dev}\n"
        "genesis, _ = harness.make_genesis(1)\n"
        "def started(read):\n"
        "    async def go():\n"
        "        node = Node(NodeConfig(block_sync=False), genesis, KVStoreApp(),\n"
        "                    ed25519.Ed25519PrivKey(bytes(32)),\n"
        "                    [MemoryNetwork().create_transport('n')], **dev)\n"
        "        await node.start()\n"
        "        try:\n"
        "            return eval(read)\n"
        "        finally:\n"
        "            await node.stop()\n"
        "            shutil.rmtree(node.consensus.wal.dir, ignore_errors=True)\n"
        "    return asyncio.run(go())\n"
        "out = {}\n"
        f"for knob, (value, read) in {NODE_KNOBS!r}.items():\n"
        "    got = []\n"
        "    for v in (value, None):\n"
        "        os.environ.pop(knob, None) if v is None else os.environ.update({knob: v})\n"
        "        got.append(eval(read) if read.startswith('trace') else started(read))\n"
        "    out[knob] = got\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_port_node_reads_its_knobs_as_the_reference_does():
    port = _node_knob_readings("tendermint_tpu_torch")
    assert port == _node_knob_readings("tendermint_tpu")
    assert port == {
        "TMTPU_VERIFYHUB_DISABLE": [True, False],
        "TMTPU_INGRESS_DISABLE": [True, False],
        "TMTPU_CATCHUP_RATE": [250.0, None],
        "TMTPU_TRACE_DIR": ["/tmp/flight", "/cfg"],
    }


#: every chaos knob, a value that arms it, and the field it sets
CHAOS_KNOBS = {
    "TMTPU_CHAOS_SEED": ("11", "seed"), "TMTPU_CHAOS_DROP": ("0.2", "drop_rate"),
    "TMTPU_CHAOS_DELAY_MS": ("3.5", "delay_ms"), "TMTPU_CHAOS_DUP": ("0.1", "duplicate_rate"),
    "TMTPU_CHAOS_REORDER": ("0.05", "reorder_rate"),
    "TMTPU_CHAOS_CORRUPT": ("0.01", "corrupt_rate"), "TMTPU_CHAOS_BW": ("2048", "bandwidth_rate"),
    "TMTPU_CHAOS_GRAY_MS": ("90", "gray_delay_ms"), "TMTPU_CHAOS_SKEW_MS": ("40", "clock_skew_ms"),
    "TMTPU_CHAOS_DRIFT": ("0.03", "clock_drift"),
    "TMTPU_CHAOS_FS_SEED": ("5", "seed"), "TMTPU_CHAOS_FS_TORN": ("0.5", "torn_write_rate"),
    "TMTPU_CHAOS_FS_TORN_OFFSET": ("12", "torn_offset"),
    "TMTPU_CHAOS_FS_LOST_FSYNC": ("0.25", "lost_fsync_rate"),
    "TMTPU_CHAOS_FS_ENOSPC": ("0.01", "enospc_rate"),
    "TMTPU_CHAOS_FS_ENOSPC_AT": ("0", "enospc_at_byte"),
    "TMTPU_CHAOS_FS_BITROT": ("0.5", "bitrot_rate"),
}


@pytest.mark.parametrize("knob", sorted(CHAOS_KNOBS))
def test_port_reads_the_chaos_knobs_as_the_reference_does(knob, monkeypatch):
    import dataclasses

    import tendermint_tpu.libs.chaos as j_chaos
    import tendermint_tpu.libs.chaosfs as j_chaosfs
    import tendermint_tpu_torch.libs.chaos as p_chaos
    import tendermint_tpu_torch.libs.chaosfs as p_chaosfs

    fs = knob.startswith("TMTPU_CHAOS_FS_")
    ref_cls = j_chaosfs.ChaosFSConfig if fs else j_chaos.ChaosConfig
    port_cls = p_chaosfs.ChaosFSConfig if fs else p_chaos.ChaosConfig
    for k in CHAOS_KNOBS:
        monkeypatch.delenv(k, raising=False)
    value, field = CHAOS_KNOBS[knob]
    readings = []
    for v in (value, None):
        if v is None:
            monkeypatch.delenv(knob)
        else:
            monkeypatch.setenv(knob, v)
        ref, port = ref_cls.from_env(), port_cls.from_env()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.enabled() == ref.enabled()
        readings.append((getattr(port, field), port.enabled()))
    assert readings[0][0] == type(readings[1][0])(value)
    assert readings[0][0] != readings[1][0]
    # a seed or a tear offset alone arms nothing
    assert readings[0][1] == (field not in ("seed", "torn_offset"))
    assert readings[1][1] is False
