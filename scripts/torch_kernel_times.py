#!/usr/bin/env python3
"""Time the hand-written CUDA kernels of a checkout's PyTorch/CUDA port on one GPU.

    python3 scripts/torch_kernel_times.py [CHECKOUT]

Imports tendermint_tpu_torch from CHECKOUT (default: the checkout this
script lies in), builds its kernels there, and prints one JSON line: the
card's name and power limit, and for each kernel at its main-path shapes
(B1 `fe_mul` at 8,192 elements, B2 `fe_pow22523` at 8,447, B3
`scan_blocks` at 8,192 and 512 chains of 15 steps, K7a `bls_miller` and
K7b `bls_final_exp` at the aggregate path's (2, 256) bucket and the
per-signature path's (128, 2)) the kernel's device time per call and
whether its output equals its plain version's. B1-B3 are timed by
torch.profiler, K7a and K7b by CUDA events around 20 and 10 launches
(the profiler recorded no device events for most of their repeats),
three repeats each. The inputs come from a fixed seed with limbs in [0,
512), and the pairing buckets from `testing.make_pairing_bucket` (8
fixed pairs, laid out as the paths lay them out: at (2, 256) item 0
holds 151 real pairs and item 1 none; at (128, 2) 101 items hold 2 real
pairs and 27 none), so the lines of two checkouts run in one call
compare like with like; a checkout must have that builder (PR 8 on).
Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SEED = 20261017
REPS = 20


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(
        sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__), "..")
    )
    sys.path.insert(0, root)
    from tendermint_tpu_torch.crypto.cuda import curve, msm
    from tendermint_tpu_torch.crypto.cuda import field as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    def limbs(*shape):
        return torch.randint(0, 512, shape + (32,), generator=gen, dtype=torch.int32).to(dev)

    def device_ms(fn, kernel):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us = sum(
            e.time_range.elapsed_us()
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
        )
        return us / REPS / 1e3 if us else None

    cases = []
    a, b = limbs(8192), limbs(8192)
    cases.append(("fe_mul", 8192, lambda: F.mul(a, b), lambda: F._mul_plain(a, b)))
    z = limbs(8447)
    cases.append(("fe_pow22523", 8447, lambda: F.pow22523(z), lambda: F._pow22523_plain(z)))
    for chains in (8192, 512):
        first = curve.Point(*(limbs(chains) for _ in range(4)))
        rest = curve.CachedPoint(*(limbs(15, chains) for _ in range(4)))
        cases.append((
            "scan_blocks", chains,
            lambda f=first, r=rest: msm.scan_blocks(f, r),
            lambda f=first, r=rest: msm._scan_blocks_plain(f, r),
        ))

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    bls_rows = []
    for shape, real in (((2, 256), [151, 0]), ((128, 2), [2] * 101 + [0] * 27)):
        ins = tt.make_pairing_bucket(real, shape[1], dev)
        lanes = BP.miller(*ins)
        for name, reps, run, plain in (
            ("bls_miller", 2 * REPS, lambda i=ins: BP.miller(*i), lambda i=ins: BP._miller_plain(*i)),
            ("bls_final_exp", REPS, lambda x=lanes: BP.final_exp(x),
             lambda x=lanes: BP._final_exp_plain(x)),
        ):
            got, want = run(), plain()
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            bls_rows.append({
                "name": name,
                "shape": list(shape),
                "ms_repeats": [events_ms(run, reps) for _ in range(3)],
                "equal_to_plain": all(torch.equal(g, w) for g, w in zip(got, want)),
            })

    rows = []
    for name, m, run, plain in cases:
        got, want = run(), plain()
        got = torch.stack(list(got)) if isinstance(got, tuple) else got
        want = torch.stack(list(want)) if isinstance(want, tuple) else want
        rows.append({
            "name": name,
            "m": m,
            "ms_repeats": [device_ms(run, f"{name}_kernel") for _ in range(3)],
            "equal_to_plain": torch.equal(got, want),
        })
    print(json.dumps({"checkout": root, "card": smi, "kernels": rows + bls_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
