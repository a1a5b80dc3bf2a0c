#!/usr/bin/env python3
"""Run phase 19 of chip_smoke.py (the sharded verifier, B6) alone on the card.

    python3 scripts/chip_sharded_phase.py > sharded.out

Builds the kernels, measures the router's cutoff on the card (as phase 9
does, so the hub's dispatches route as in the whole script), signs phase
3's 54 commits of 150 validators, then runs `drive_sharded` (the sharded
kernel_eq at 4 and 3 shards against the unsharded one, the tampered
range through the mesh, the hub over 4 shards), holds B1-B3 torch.equal
to their plain versions at every shape the phase gave them (path and
worst-case inputs, `audit_shapes`, which also times each kernel's largest
size on the 4-shard kernel_eq), and times a `kernels` row for each other
new B2 and B3 size and the 3-shard kernel_eq's largest B1 size. Prints
the card's name and power limit, then one JSON line per step with its
seconds; every assertion of the phase applies, and it exits non-zero
without a card. A quicker look at the phase than the whole script, which
stays the proof that the port runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_sharded_phase: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.cuda import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"cutoff": batch._measure_cutoff(dev)}), flush=True)
    entries = cs.build_commits(cs.N_VALS, cs.N_COMMITS)

    audit = cs.ShapeAudit()
    t0 = time.perf_counter()
    sharded = cs.drive_sharded(dev, entries, audit)
    sharded["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"sharded": sharded}), flush=True)

    t0 = time.perf_counter()
    rows: list = []
    held = cs.audit_shapes(dev, audit, rows, (cs._sh_path("kernel_eq", 4),))
    print(json.dumps({"held": held, "s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    cs._sharded_rows(dev, audit, rows, cs._sharded_by_path(sharded))
    print(json.dumps({"rows": rows, "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
