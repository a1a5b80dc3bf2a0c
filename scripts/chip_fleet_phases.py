#!/usr/bin/env python3
"""Run phases 17-18 of chip_smoke.py alone on one GPU.

    python3 scripts/chip_fleet_phases.py > fleet.out

Builds the kernels, measures the router's cutoff on the card (as phase 9
does, so the backfill windows route as in the whole script), then runs
the light fleet (phase 17, `drive_light_fleet`) and BootFleet (phase 18,
`drive_statesync_fleet`), holds K7a and K7b torch.equal to their plain
versions at every shape the two phases gave them, times a `kernels` row
for each K7a/K7b shape other than phase 14's (2, 256) and (128, 2), and
holds and times B1-B3 at the shapes of the 48-height backfill
(`audit_shapes` with that path as the timed one). Prints the card's name,
power limit and max SM clock, then one JSON line per step with its
seconds; every assertion of the two phases applies, and it exits
non-zero without a card. A quicker look at the two phases than the whole
script, which stays the proof that the port runs.
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
        print("chip_fleet_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.cuda import _build
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"cutoff": batch._measure_cutoff(dev)}), flush=True)

    audit, pairing = cs.ShapeAudit(), cs.PairingAudit()
    t0 = time.perf_counter()
    lf = cs.drive_light_fleet(dev, audit, pairing)
    lf["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"light_fleet": lf}), flush=True)
    t0 = time.perf_counter()
    ssf = cs.drive_statesync_fleet(dev, audit, pairing)
    ssf["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"statesync_fleet": ssf}), flush=True)

    t0 = time.perf_counter()
    held = cs._hold_pairing_shapes(dev, pairing)
    print(json.dumps({"held": held, "s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    kernels = {k.name: k for k in (BP.MILLER, BP.FINAL_EXP)}
    rows = [cs._pairing_row(dev, kernels[name], shape, rec["inputs"], next(iter(rec["calls"])))
            for (name, shape), rec in sorted(pairing.seen.items())
            if shape not in ((2, 256), (128, 2))]
    print(json.dumps({"pairing_rows": rows, "s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    edwards_rows: list = []
    edwards_held = cs.audit_shapes(dev, audit, edwards_rows, (cs.SSF_DEEP,))
    print(json.dumps({"edwards_rows": edwards_rows, "held": edwards_held,
                      "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
