#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tendermint_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — range-batched ed25519 commit verification —
on the card and checks every hand-written kernel on it. Phases (any
failure exits non-zero, nothing is caught and carried past):

  1. build the CUDA kernels from csrc/ (nvcc, sm_90a), print the seconds
     and each kernel's register/spill report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it (B1 at 8,192, 64 and 1 elements,
     B3 at 8,192 and 512 chains of 15 steps, with an all-511 chain, a
     y == x chain and signed limbs among them), with torch.equal
     (integer arithmetic: the tolerance is zero); time
     each kernel alone (torch.profiler, three repeats), through its
     wrapper (CUDA events, three repeats), and its plain version;
  3. verify_commit_range over 54 commits of a 150-validator set (one
     8,192-signature bucket, 150 unique keys) with the launch counts set
     to 0 just before and read just after; then verify_batch_eq over every
     signature of those commits (8,100, the bench.py headline shape);
  4. the same range with one tampered signature: verify_commit_range must
     raise with the right failed_index, and verify_resolved must
     attribute exactly that signature through kernel_sig;
  5. cross-check 256 bitmap entries against host single verification;
  6. a breakdown of one range-sized `kernel_eq`: host prep, copy, wall
     time, the card's busy time and idle share, each kernel's summed
     device time (torch.profiler), and B1's host time in `field.mul`
     with its calls by size.

Prints the card's name and power limit, `breakdown`, `slice` and
`kernels` JSON lines, and last {"ok": true, "device": {...}}. Imports nothing of JAX
or of the JAX package. Build output goes to build/torch_ext/.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

N_VALS = 150
N_COMMITS = 54
CHAIN_ID = "smoke-chain"
TAMPER_COMMIT, TAMPER_VAL = 20, 5
SEED = 20261016

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and the
# CUDA-core float32 rate (an FMA counted as two operations). All three
# kernels run their convolutions in FP32 FFMA at that rate; the int32
# carries issue at half of it, so for those the operation bound below is
# optimistic by up to 2x.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

# Operations per element, counted from the kernels' arithmetic (a
# multiply-add is two operations, as in the peak rate):
#   multiply: 32x32 convolution (2048), fold x38 (64), 4 carry passes of
#   and/shift/add over 32 limbs plus the x38 wrap (4 * 97)
#   squaring: the 496 cross products and 32 squares (2 * 528), doubling
#   the 64 cross sums (64), then the same fold and carries
FE_CARRY_OPS = 4 * (3 * 32 + 1)
FE_MUL_OPS = 2 * 32 * 32 + 2 * 32 + FE_CARRY_OPS
FE_SQR_OPS = 2 * 528 + 64 + 2 * 32 + FE_CARRY_OPS
FE_SUB_OPS = 32 + 2 * (3 * 32 + 1)  # - b (the 8p added is zero), two carry passes
FE_ADD_OPS = 32 + (3 * 32 + 1)
# the pow22523 chain: 251 squarings + 11 multiplies (csrc/fe_pow22523.cu)
POW22523_OPS = 251 * FE_SQR_OPS + 11 * FE_MUL_OPS
ADD_CACHED_OPS = 8 * FE_MUL_OPS + 3 * FE_SUB_OPS + 3 * FE_ADD_OPS
LIMB_BYTES = 32 * 4


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(fn, reps: int) -> float:
    """Milliseconds per call on the card's clock (CUDA events around
    `reps` calls after a warm-up): what a caller pays, host gaps between
    launches included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, reps: int = 1) -> list:
    """The card's own activity records (kernels, copies) of `reps` calls,
    from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(fn, reps: int, name: str | None = None) -> float | None:
    """Device milliseconds per call: the summed duration of the card's
    activity records of one call (of kernels whose name holds `name`,
    when given). None when the profiler recorded no device activity."""
    events = [e for e in _device_events(fn, reps) if name is None or name in e.name]
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def check_kernels(dev) -> list[dict]:
    """Phase 2: each kernel against its plain version on the card."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import _build, curve, msm
    from tendermint_tpu_torch.crypto.cuda import field as F

    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def limbs(*shape):
        return torch.randint(0, 512, shape + (32,), generator=gen, dtype=torch.int32).to(dev)

    def scan_inputs(chains, steps):
        """B3's operands: limbs in [0, 512), chain 0 at 511 in every limb
        (where the true 8p and the reference's zero part ways), chain 1
        with y == x, and the upper half of the chains in [-300, 300)."""
        def signed(*shape):
            return torch.randint(-300, 300, shape + (32,), generator=gen,
                                 dtype=torch.int32).to(dev)

        half = chains // 2
        first = [torch.cat([limbs(half), signed(chains - half)]) for _ in range(4)]
        rest = [torch.cat([limbs(steps, half), signed(steps, chains - half)], 1)
                for _ in range(4)]
        for t in first:
            t[0] = 511
        for t in rest:
            t[:, 0] = 511
        first[1][1] = first[0][1]
        return curve.Point(*first), curve.CachedPoint(*rest)

    rows = []

    def record(kernel, m, run, plain, n_bytes, n_ops, reps):
        got, want = run(), plain()
        torch.cuda.synchronize()
        got_t = torch.stack(list(got)) if isinstance(got, tuple) else got
        want_t = torch.stack(list(want)) if isinstance(want, tuple) else want
        if not torch.equal(got_t, want_t):
            raise AssertionError(f"{kernel.name} (m={m}): kernel disagrees with its plain version")
        err = int((got_t - want_t).abs().max().item())
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        # the kernel alone on the card (profiler), three repeats
        repeats = [_device_ms(run, reps, name=f"{kernel.name}_kernel") for _ in range(3)]
        wrappers = [_time_ms(run, reps) for _ in range(3)]
        measured = sorted(r for r in repeats if r is not None)
        ms = measured[len(measured) // 2] if measured else None
        wrapper_ms = sorted(wrappers)[1]
        plain_ms = _time_ms(plain, max(1, reps // 5))
        rows.append({
            "name": kernel.name,
            "m": m,
            "route": "cuda",
            "source": f"tendermint_tpu_torch/crypto/cuda/csrc/{kernel.source}.cu",
            "replaces": kernel.replaces,
            "max_abs_err": err,
            "match": True,
            # else the CUDA-event time per wrapper call, which includes the
            # host's launch gap
            "ms": ms if ms is not None else wrapper_ms,
            "ms_source": "profiler" if ms is not None else "cuda_events",
            "ms_repeats": repeats,
            "share_of_bound": bound_ms / (ms if ms is not None else wrapper_ms),
            # CUDA events per call through the wrapper: what a caller pays
            "wrapper_ms": wrapper_ms,
            "wrapper_ms_repeats": wrappers,
            "plain_ms": plain_ms,
            "plain_device_ms": _device_ms(plain, 1),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes these
        })

    # B1 at 8,192 elements (the R-side width), row 0 the all-511 worst
    # case; and at 1 and 64 elements, where most main-path launches land
    for m, reps in ((8192, 200), (64, 1000), (1, 1000)):
        a, b = limbs(m), limbs(m)
        a[0], b[0] = 511, 511
        record(F.FE_MUL, m, lambda a=a, b=b: F.mul(a, b), lambda a=a, b=b: F._mul_plain(a, b),
               3 * LIMB_BYTES * m, FE_MUL_OPS * m, reps=reps)

    # B2 at 8,447 elements: 255 unique keys + 8,192 R points, one decompress
    z = limbs(8447)
    z[0] = 511
    record(F.FE_POW22523, 8447, lambda: F.pow22523(z), lambda: F._pow22523_plain(z),
           2 * LIMB_BYTES * 8447, POW22523_OPS * 8447, reps=20)

    # B3 at the R-side MSM (16 windows x g = 512 blocks = 8,192 chains of
    # 15 cached additions) and at the A side (512 chains)
    steps = msm._BLOCK - 1
    for chains, reps in ((16 * 512, 20), (512, 100)):
        first, rest = scan_inputs(chains, steps)
        record(msm.SCAN_BLOCKS, chains, lambda f=first, r=rest: msm.scan_blocks(f, r),
               lambda f=first, r=rest: msm._scan_blocks_plain(f, r),
               chains * LIMB_BYTES * 4 * (1 + steps + steps + 1),
               chains * steps * ADD_CACHED_OPS, reps=reps)
    for k in _build.KERNELS.values():
        k.launches = 0
    return rows


def build_commits(n_vals: int, n_commits: int):
    from tendermint_tpu_torch import testing as tt

    vals, keys = tt.make_validator_set(n_vals)
    entries = []
    for h in range(1, n_commits + 1):
        bid = tt.make_block_id(b"smoke-%d" % h)
        entries.append((vals, bid, h, tt.make_commit(CHAIN_ID, h, 0, bid, vals, keys)))
    return entries


def all_items(entries):
    return [
        (vals.validators[i].pub_key.bytes(), commit.vote_sign_bytes(CHAIN_ID, i), cs.signature)
        for vals, _bid, _h, commit in entries
        for i, cs in enumerate(commit.signatures)
    ]


def range_items(entries):
    """The (pub, msg, sig) triples verify_commit_range batches: per commit,
    block votes in index order up to the first tally above 2/3."""
    out = []
    for vals, _bid, _h, commit in entries:
        need, tallied = vals.total_voting_power() * 2 // 3, 0
        for i, cs in enumerate(commit.signatures):
            if not cs.is_commit():
                continue
            val = vals.validators[i]
            out.append((val.pub_key.bytes(), commit.vote_sign_bytes(CHAIN_ID, i), cs.signature))
            tallied += val.voting_power
            if tallied > need:
                break
    return out


def tamper(entries, ci: int, vi: int):
    from dataclasses import replace

    vals, bid, h, commit = entries[ci]
    sigs = list(commit.signatures)
    s = sigs[vi].signature
    sigs[vi] = replace(sigs[vi], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    out = list(entries)
    out[ci] = (vals, bid, h, replace(commit, signatures=tuple(sigs)))
    return out


def drive_main_path(dev, entries) -> dict:
    """Phase 3: the port's main path, with the launch counts around it."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import _build, verify as V
    from tendermint_tpu_torch.types.validation import verify_commit_range

    n_range = len(range_items(entries))
    for k in _build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    verify_commit_range(CHAIN_ID, entries, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _build.KERNELS.items()}

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify_commit_range(CHAIN_ID, entries, device=dev)
        walls.append(time.perf_counter() - t0)
    walls.sort()

    items = all_items(entries)
    t0 = time.perf_counter()
    bitmap = V.verify_batch_eq(items, dev)
    batch_s = time.perf_counter() - t0
    if not bitmap.all() or len(bitmap) != len(items):
        raise AssertionError("verify_batch_eq rejected valid signatures")

    # the host floor: the same range signatures, one by one on every core
    from tendermint_tpu_torch.crypto.batch import CPUBatchVerifier
    from tendermint_tpu_torch.crypto.ed25519 import _HAVE_OPENSSL, Ed25519PubKey

    cpu_items = range_items(entries)
    bv = CPUBatchVerifier(parallel=True)
    for pub, msg, sig in cpu_items:
        bv.add(Ed25519PubKey(pub), msg, sig)
    t0 = time.perf_counter()
    ok, _ = bv.verify()
    cpu_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("host verification rejected valid signatures")
    return {
        "launches": launches,
        "slice": {
            "entry": "verify_commit_range",
            "commits": len(entries),
            "validators": len(entries[0][0]),
            "sigs": n_range,
            "bucket": V._bucket(n_range),
            "group_bucket": V._group_bucket(len(entries[0][0])),
            "first_wall_s": first_s,
            "wall_s": walls[1],
            "sigs_per_s": n_range / walls[1],
            "batch_eq": {
                "entry": "verify_batch_eq",
                "sigs": len(items),
                "bucket": V._bucket(len(items)),
                "wall_s": batch_s,
                "sigs_per_s": len(items) / batch_s,
            },
            "cpu_floor": {
                "entry": "CPUBatchVerifier(parallel=True)",
                "sigs": len(cpu_items),
                "cores": os.cpu_count(),
                "openssl": _HAVE_OPENSSL,
                "wall_s": cpu_s,
                "sigs_per_s": len(cpu_items) / cpu_s,
            },
        },
    }


def breakdown(dev, entries) -> dict:
    """Where one range-sized batch spends its time: host resolve and prep,
    the copy to the card, and one `kernel_eq` call — its wall time, the
    card's busy time inside it (profiler), the idle share, and the kernels
    that took the most device time."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import verify as V

    items = range_items(entries)
    t0 = time.perf_counter()
    resolved = [V.resolve_ed25519(*it) for it in items]
    t1 = time.perf_counter()
    ops = V.prepare_batch_eq(resolved, pad_to=V._bucket(len(items)))
    t2 = time.perf_counter()
    dev_ops = V._to_device(ops, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    def step():
        _bitmap, eq_ok = V.kernel_eq(*dev_ops)
        if not bool(eq_ok):
            raise AssertionError("kernel_eq rejected a valid batch")

    step()  # warm
    t4 = time.perf_counter()
    step()
    wall = time.perf_counter() - t4
    events = _device_events(step)

    # B1's host side inside one kernel_eq: seconds spent in field.mul (the
    # wrapper, its checks and the ctypes launch), and its calls by size
    from tendermint_tpu_torch.crypto.cuda import field as F

    real_mul, mul_s, mul_calls = F.mul, [0.0], {}

    def timed_mul(a, b):
        t = time.perf_counter()
        out = real_mul(a, b)
        mul_s[0] += time.perf_counter() - t
        m = out.numel() // F.LIMBS
        mul_calls[m] = mul_calls.get(m, 0) + 1
        return out

    F.mul = timed_mul
    try:
        t5 = time.perf_counter()
        step()
        timed_wall = time.perf_counter() - t5
    finally:
        F.mul = real_mul
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    by_name: dict[str, list] = {}
    for e in events:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us() / 1e3
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    ported = {
        k: sum(ms for name, (ms, _n) in by_name.items() if f"{k}_kernel" in name)
        for k in ("fe_mul", "fe_pow22523", "scan_blocks")
    }
    return {
        "entry": "kernel_eq",
        "sigs": len(items),
        "bucket": V._bucket(len(items)),
        "host_resolve_s": t1 - t0,
        "host_prep_s": t2 - t1,
        "to_device_s": t3 - t2,
        "kernel_eq_wall_s": wall,
        "device_busy_s": busy if events else None,
        "device_idle_share": (1 - busy / wall) if events else None,
        "device_activities": len(events),
        "ported_kernels_device_ms": ported,
        "fe_mul_calls": sum(mul_calls.values()),
        "fe_mul_host_s": mul_s[0],
        "fe_mul_host_ms_per_call": mul_s[0] / max(1, sum(mul_calls.values())) * 1e3,
        "fe_mul_calls_by_m": {str(m): n for m, n in sorted(mul_calls.items())},
        "kernel_eq_wall_s_with_fe_mul_timed": timed_wall,
        "top_device_ms": [[name[:140], ms, n] for name, (ms, n) in top],
    }


def drive_tampered(dev, entries) -> None:
    """Phases 4 and 5: a planted bad signature is found, attributed, and
    the bitmap agrees with host single verification."""
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit_range

    bad = tamper(entries, TAMPER_COMMIT, TAMPER_VAL)
    try:
        verify_commit_range(CHAIN_ID, bad, device=dev)
    except InvalidCommitError as e:
        if getattr(e, "failed_index", None) != TAMPER_COMMIT:
            raise AssertionError(f"failed_index {getattr(e, 'failed_index', None)}") from e
        if f"index {TAMPER_VAL}" not in str(e):
            raise AssertionError(f"wrong signature blamed: {e}") from e
    else:
        raise AssertionError("tampered range verified")

    items = range_items(bad)
    per_commit = len(items) // len(bad)
    bad_pos = TAMPER_COMMIT * per_commit + TAMPER_VAL
    calls = []
    kernel_sig = V.kernel_sig

    def counted_kernel_sig(*ops):
        calls.append(1)
        return kernel_sig(*ops)

    V.kernel_sig = counted_kernel_sig
    try:
        bitmap = V.verify_resolved([V.resolve_ed25519(*it) for it in items], dev)
    finally:
        V.kernel_sig = kernel_sig
    if calls != [1] or bitmap[bad_pos] or int(bitmap.sum()) != len(items) - 1:
        raise AssertionError("verify_resolved did not attribute the tampered signature")

    rng = random.Random(SEED)
    sample = sorted(set(rng.sample(range(len(items)), min(255, len(items)))) | {bad_pos})
    for i in sample:
        pub, msg, sig = items[i]
        if bool(bitmap[i]) != Ed25519PubKey(pub).verify_signature(msg, sig):
            raise AssertionError(f"bitmap entry {i} disagrees with host verification")
    print(f"cross-check: {len(sample)} bitmap entries agree with host verification")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "tendermint_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    from tendermint_tpu_torch.crypto.cuda import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for stem, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    rows = check_kernels(dev)

    t0 = time.perf_counter()
    entries = build_commits(N_VALS, N_COMMITS)
    print(f"signed {N_VALS * N_COMMITS} votes in {time.perf_counter() - t0:.1f} s")
    run = drive_main_path(dev, entries)
    for row in rows:
        row["launches"] = run["launches"][row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    drive_tampered(dev, entries)
    bd = breakdown(dev, entries)
    print(json.dumps({"breakdown": bd}))
    for row in rows:
        # the kernel's summed device time inside one main-path kernel_eq
        row["main_path_device_ms"] = bd["ported_kernels_device_ms"][row["name"]]

    print(json.dumps({"slice": run["slice"]}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
