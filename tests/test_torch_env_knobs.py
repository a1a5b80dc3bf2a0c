"""The reference's env knobs that the port reads as it does, each in a
fresh interpreter (both are read once, at import): TMTPU_MIN_HASH_BATCH
sets `crypto.hash_hub.MIN_DEVICE_BATCH` and TMTPU_MAX_BUCKET sets
`crypto.cuda.verify._MAX_BUCKET` (the reference's
`crypto/tpu/verify._MAX_BUCKET`), with the reference's defaults when
unset."""

from __future__ import annotations

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
