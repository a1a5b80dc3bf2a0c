"""The reference's env knobs that the port reads as it does, each in a
fresh interpreter. Two are read once, at import: TMTPU_MIN_HASH_BATCH
sets `crypto.hash_hub.MIN_DEVICE_BATCH` and TMTPU_MAX_BUCKET sets
`crypto.cuda.verify._MAX_BUCKET` (the reference's
`crypto/tpu/verify._MAX_BUCKET`), with the reference's defaults when
unset. Two steer the sharded verifier, read with the knob set and then
unset in one interpreter: TMTPU_MESH_MAX_DEVICES caps the mesh at
enumeration (the port's CUDA count stood in by 8, the reference's 8
virtual devices) and TMTPU_FORCE_SHARDED drops the size gate at each
call (the port on 8 logical CPU shards)."""

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
