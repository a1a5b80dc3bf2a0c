#!/usr/bin/env python3
"""Run phases 25-26 of chip_smoke.py (the full node: block-sync between
two Nodes over TCP with the secret connection, and a validator network of
Nodes) alone on the card, with phase 12 on the same chain beside them.

    python3 scripts/chip_node_phases.py > node.out

Builds the kernels, measures the router's cutoff on the card (as phase 9
does, so every hub routes as in the whole script), builds phase 12's
150-validator 256-block chain once on the host, replays it through a
hand-fed BlockSyncReactor (`drive_blocksync`, phase 12: the blocks/s the
node path is compared with), then runs `drive_node_blocksync` (phase 25:
a source Node and a joiner Node over TCP, and the byzantine source's
tampered pass) and `drive_node_net` (phase 26: three validator Nodes over
the memory transport on the card and on the host, byte-equal); then
holds B1-B3 torch.equal to their plain versions at every shape phases 12
and 25 gave them (path and worst-case inputs, `audit_shapes`, which also
times each kernel's largest size on phase 25's path). Prints the card's
name and power limit, then one JSON line per step with its seconds;
every assertion of the phases applies, and it exits non-zero without a
card. A quicker look at the phases than the whole script, which stays
the proof that the port runs.
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
        print("chip_node_phases: no CUDA device is available", file=sys.stderr)
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

    chain = cs.build_chain(cs.N_VALS, cs.N_BS_BLOCKS)
    print(json.dumps({"chain_build_s": chain["build_s"]}), flush=True)
    audit = cs.ShapeAudit()
    t0 = time.perf_counter()
    bs = cs.drive_blocksync(dev, audit, chain)
    print(json.dumps({"blocksync": {k: bs[k] for k in (
        "blocks_applied", "wall_s", "blocks_per_s", "ranges", "launches")},
        "phase_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    nb = cs.drive_node_blocksync(dev, audit, chain)
    nb["phase12_blocks_per_s"] = bs["blocks_per_s"]
    nb["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"node_blocksync": nb}), flush=True)
    t0 = time.perf_counter()
    nn = cs.drive_node_net(dev)
    nn["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"node_net": nn}), flush=True)

    t0 = time.perf_counter()
    rows: list = []
    held = cs.audit_shapes(dev, audit, rows, (cs.NB_MAIN,))
    print(json.dumps({"held": held, "rows": rows, "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
