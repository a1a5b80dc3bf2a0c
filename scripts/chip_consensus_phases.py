#!/usr/bin/env python3
"""Run phases 23-24 of chip_smoke.py (consensus: one node's vote ingest
at 150 validators, and live consensus byte-checked against the host)
alone on the card.

    python3 scripts/chip_consensus_phases.py > consensus.out

Builds the kernels, measures the router's cutoff on the card (as phase 9
does, so every hub routes as in the whole script), then runs
`drive_consensus_ingest` (bench_consensus_ingest at 150 validators, the
2,744-vote wide burst that reaches `kernel_eq`, and its tampered twin
through a ConsensusReactor) and `drive_consensus_live` (the frozen-clock
ed25519 network to height 4 against the host's, a crashed node resumed
from its WAL, and the BLS aggregate network to height 3 against the
host's); then holds B1-B3 torch.equal to their plain versions at every
shape the bursts gave them (path and worst-case inputs, `audit_shapes`,
which also times each kernel's largest size on the wide burst) and K7a /
K7b at the BLS network's pairing shape. Prints the card's name and power
limit, then one JSON line per step with its seconds; every assertion of
the phases applies, and it exits non-zero without a card. A quicker look
at the phases than the whole script, which stays the proof that the port
runs.
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
        print("chip_consensus_phases: no CUDA device is available", file=sys.stderr)
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
    for name, run in (("consensus_ingest", lambda: cs.drive_consensus_ingest(dev, audit)),
                      ("consensus_live", lambda: cs.drive_consensus_live(dev, pairing))):
        t0 = time.perf_counter()
        rec = run()
        rec["phase_s"] = time.perf_counter() - t0
        print(json.dumps({name: rec}), flush=True)

    t0 = time.perf_counter()
    rows: list = []
    held = cs.audit_shapes(dev, audit, rows, (cs.CI_MAIN,))
    pairing_held = cs._hold_pairing_shapes(dev, pairing)
    print(json.dumps({"held": held, "pairing_held": pairing_held, "rows": rows,
                      "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
