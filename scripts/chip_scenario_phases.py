#!/usr/bin/env python3
"""Run the scenario harness's committee-scale rows on the card: the rest
of the 50-validator committee that chip_smoke.py's phase 27 leaves out,
and, on request, the 150-validator soak.

    python3 scripts/chip_scenario_phases.py [--soak150] [--only GROUPS] [--phase27]

Builds the kernels and measures the router's cutoff on the card (as
chip_smoke.py's phase 9 does, so every hub routes as in the whole script),
then runs, each on device="cuda" with its nodes sharing one hub on the
card:

  * `soak`: bench.py's five chaos_soak rows at 50 validators
    (bench.py:598-640: baseline, lossy_links, corrupt_wire,
    asym_partition and full_taxonomy; target height 2, time_scale 4,
    stall 90 s, degree 8, seed 7, timeout 300 s);
  * `byz`: the 50-validator byzantine sweep (tests/test_byzantine.py:
    797-853: byz_equivocation, byz_equivocation_partition,
    byz_amnesia_skew, byz_withhold and byz_invalid_sig; target 4,
    seed 13, time_scale 4, stall 120 s, timeout 420 s, audit_k 4) and the
    f-max soak (byz_full_taxonomy: 16 traitors, target 4, seed 29,
    time_scale 8, stall 240 s, timeout 900 s, audit_k 6);
  * `soak150` (with --soak150): the reference's 150-validator
    full_taxonomy soak (tests/test_routernet.py:558-587: target 2,
    seed 29, time_scale 15, stall 240 s, timeout 1,200 s, degree 6,
    gossip_sleep 0.4).

`--only soak,byz` picks groups; `--phase27` runs chip_smoke.py's phase 27
alone instead (its assertions apply). Every run is bounded by the
runner's own deadline and an outer timeout 60 s past it. Prints the
card's name and power limit, then one JSON line per run with its
structured outcome (outcome, heights, blocks/s, recover_s, fault
counters, the audit, the hub's dispatches by route, the launches) and
its wall seconds. Exits 1 if a run is not `ok` with a green audit, 2
without a card; a device error raises out of its run. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOAK50 = dict(n_vals=50, target_height=2, seed=7, timeout_s=300.0, stall_s=90.0,
              time_scale=4.0, degree=8)
SOAK50_NAMES = ["baseline", "lossy_links", "corrupt_wire", "asym_partition", "full_taxonomy"]
BYZ50 = dict(n_vals=50, target_height=4, seed=13, timeout_s=420.0, stall_s=120.0,
             time_scale=4.0, degree=8, audit_k=4)
BYZ50_NAMES = ["byz_equivocation", "byz_equivocation_partition", "byz_amnesia_skew",
               "byz_withhold", "byz_invalid_sig"]
FMAX50 = dict(n_vals=50, target_height=4, seed=29, timeout_s=900.0, stall_s=240.0,
              time_scale=8.0, degree=8, audit_k=6)
SOAK150 = dict(n_vals=150, target_height=2, seed=29, timeout_s=1200.0, stall_s=240.0,
               time_scale=15.0, degree=6, gossip_sleep=0.4)


def _runs(groups: set[str]) -> list[tuple[str, str, dict]]:
    runs = []
    if "soak" in groups:
        runs += [("soak", name, SOAK50) for name in SOAK50_NAMES]
    if "byz" in groups:
        runs += [("byz", name, BYZ50) for name in BYZ50_NAMES]
        runs.append(("byz", "byz_full_taxonomy", FMAX50))
    if "soak150" in groups:
        runs.append(("soak150", "full_taxonomy", SOAK150))
    return runs


def _one(cs, sc, dev, group: str, name: str, params: dict) -> dict:
    """One bounded run: its structured outcome, the hub's routes and the
    launches."""
    cs._launch_counts(reset=True)
    t0 = time.perf_counter()

    async def bounded():
        return await asyncio.wait_for(
            cs._with_hub(dev, lambda: sc.run_scenario(name, device=dev, **params)),
            params["timeout_s"] + 60.0)

    try:
        res, log, hs = asyncio.run(bounded())
    except asyncio.TimeoutError:
        return {"group": group, "scenario": name, "n_vals": params["n_vals"],
                "outcome": "timeout", "wall_s": time.perf_counter() - t0,
                "parameters": params}
    d = res.as_dict()
    d.pop("byz_actions", None)
    d.update(group=group, parameters=params, wall_s=time.perf_counter() - t0,
             routes=cs._split_by_route([(x["n"], x["route"]) for x in log]),
             hub_cache_hits=hs["cache_hits"], hub_verify_errors=hs["verify_errors"],
             launches=cs._nonzero(cs._launch_counts()))
    return d


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--soak150", action="store_true", help="also run the 150-validator soak")
    ap.add_argument("--only", default="", help="comma-separated groups: soak, byz, soak150")
    ap.add_argument("--phase27", action="store_true", help="run chip_smoke.py's phase 27 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_scenario_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.consensus import scenarios as sc
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

    if args.phase27:
        pairing = cs.PairingAudit()
        t0 = time.perf_counter()
        out = cs.drive_scenarios(dev, pairing)
        print(json.dumps({"scenarios": out}), flush=True)
        held = cs._hold_pairing_shapes(dev, pairing)
        print(json.dumps({"pairing_shapes": held, "s": time.perf_counter() - t0}), flush=True)
        print(json.dumps({"wall_s": time.perf_counter() - t_start}))
        return 0

    groups = set(filter(None, args.only.split(","))) or {"soak", "byz"}
    if args.soak150:
        groups.add("soak150")
    bad = []
    for group, name, params in _runs(groups):
        rec = _one(cs, sc, dev, group, name, params)
        print(json.dumps({"run": rec}, default=str), flush=True)
        if rec["outcome"] != "ok" or not (rec.get("audit") or {}).get("ok"):
            bad.append(f"{group}:{name}")
    print(json.dumps({"not_ok": bad, "wall_s": time.perf_counter() - t_start}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
