#!/usr/bin/env python3
"""Run phases 20-22 of chip_smoke.py (the verifyd sidecar, the tx front
door, the evidence pool) alone on the card.

    python3 scripts/chip_verifyd_phases.py > verifyd.out

Builds the kernels, measures the router's cutoff on the card (as phase 9
does, so every hub routes as in the whole script), then runs
`drive_verifyd` (bench_verifyd(4, 1000) through the sidecar and local,
phase 3's commits packed across four worker processes and their tampered
pass, the daemon's death and restart, a 21-validator BLS aggregate
through the sidecar, the CLI), `drive_tx_flood` (bench_tx_flood(10_000,
2), then the same txs wide enough for the card against the host path)
and `drive_evidence`; then holds B1-B3 torch.equal to their plain
versions at every shape those paths gave them (path and worst-case
inputs, `audit_shapes`, which also times each kernel's largest size on
the packed ranges and the wide flood) and K7a/K7b at the aggregate's
shape. Prints the card's name and power limit, then one JSON line per
step with its seconds; every assertion of the phases applies, and it
exits non-zero without a card. A quicker look at the phases than the
whole script, which stays the proof that the port runs.
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
        print("chip_verifyd_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.cuda import _build
    from tendermint_tpu_torch.crypto.cuda import bls_pairing  # noqa: F401  (registers K7a, K7b)
    from tendermint_tpu_torch.crypto.cuda import sha256  # noqa: F401  (registers B8)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"cutoff": batch._measure_cutoff(dev)}), flush=True)

    audit, pairing = cs.ShapeAudit(), cs.PairingAudit()
    for name, run in (("verifyd", lambda: cs.drive_verifyd(dev, audit, pairing)),
                      ("tx_ingress", lambda: cs.drive_tx_flood(dev, audit)),
                      ("evidence", lambda: cs.drive_evidence(dev))):
        t0 = time.perf_counter()
        rec = run()
        rec["phase_s"] = time.perf_counter() - t0
        print(json.dumps({name: rec}), flush=True)

    t0 = time.perf_counter()
    rows: list = []
    held = cs.audit_shapes(dev, audit, rows, (cs.VD_PACKED, cs.TX_CARD))
    pairing_held = cs._hold_pairing_shapes(dev, pairing)
    print(json.dumps({"held": held, "pairing_held": pairing_held, "rows": rows,
                      "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
