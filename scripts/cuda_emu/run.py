#!/usr/bin/env python3
"""Rehearse the port's CUDA kernels on the CPU, against their plain versions.

    python3 scripts/cuda_emu/run.py [--eager] [--tsan]

A machine without nvcc or a card cannot build the kernels in
tendermint_tpu_torch/crypto/cuda/csrc/, but g++ compiles a copy of them
once cuda_runtime.h and launch.cuh (this directory) stand in for the CUDA
headers and each `kernel<<<grid, block, ...>>>(args)` launch is rewritten
as a call that runs the grid's blocks one after another, each block's
threads as std::threads. The copies go to build/cuda_emu/ at the root of
the checkout. Each emulated kernel then runs through ctypes on CPU
tensors and is held, limb for limb, against its plain PyTorch version:
B3 on chain counts around its eight chains per block, with an all-511
chain, a y == x chain and signed limbs; B1 (two operands, a squaring, a
broadcast constant) and B2 on limbs in [0, 512) and [-511, 512), row 0
at 511; K7a (bls_miller) and K7b (bls_final_exp) on pairing batches of
real pairs at (2, 2) and (2, 4), the latter with pad pairs, and on p - 1
in every input with zero lines and pad pairs; K7b alone also on lanes of
p - 1, of one, and an item whose product is zero; B8 (sha256_bytes) on
batches of 1 to 97 messages of 0 to 503 bytes across the padding edges,
packed after a prefix of 0 to 15 bytes so that they start at every
alignment, against its plain version and hashlib, and its one-thread
cycle probe against hashlib.

--eager runs each cp.async copy when it is issued instead of when its
group is waited for. --tsan builds with ThreadSanitizer, which reports
any access to shared memory that no barrier orders (a missing
__syncwarp). Nothing here catches what is particular to nvcc: what it
refuses to compile, registers, spills, speed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CSRC = ROOT / "tendermint_tpu_torch" / "crypto" / "cuda" / "csrc"
OUT = ROOT / "build" / "cuda_emu"
KERNELS = ("scan_blocks", "fe_mul", "fe_pow22523", "bls_miller", "bls_final_exp", "sha256")


def build(flags: list[str], suffix: str) -> None:
    src = OUT / "src"
    src.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cu*"):
        if f.name != "launch.cuh":
            text = re.sub(
                r"(\w+)<<<(.*?)>>>\((.*?)\);",
                lambda m: f"emu_launch({m.group(2)}, [=] {{ {m.group(1)}({m.group(3)}); }});",
                f.read_text(),
                flags=re.S,
            )
            # dynamic shared memory: the block's buffer that emu_launch holds
            text = re.sub(
                r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                lambda m: f"{m.group(1)}* {m.group(2)} = ({m.group(1)}*)emu_dynamic_smem;",
                text,
            )
            (src / f.name).write_text(text)
    (src / "launch.cuh").write_text((HERE / "launch.cuh").read_text())
    procs = [
        subprocess.Popen(["g++", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(HERE),
                          *flags, "-x", "c++", str(src / f"{k}.cu"),
                          "-o", str(OUT / f"lib{k}{suffix}.so")])
        for k in KERNELS
    ]
    if any(p.wait() for p in procs):
        raise SystemExit("g++ failed")


def check(suffix: str) -> bool:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from tendermint_tpu_torch.crypto.cuda import curve as C
    from tendermint_tpu_torch.crypto.cuda import field as F
    from tendermint_tpu_torch.crypto.cuda import msm as M

    torch.set_num_threads(1)  # no intra-op threads beside the emulated ones
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {k: ctypes.CDLL(str(OUT / f"lib{k}{suffix}.so")) for k in KERNELS}
    scan = libs["scan_blocks"].scan_blocks_launch
    scan.argtypes = [P] * 12 + [I64, I32, I32, P]
    mul = libs["fe_mul"].fe_mul_launch
    mul.argtypes = [P, I32, P, I32, P, I64, I32, P]
    pow22523 = libs["fe_pow22523"].fe_pow22523_launch
    pow22523.argtypes = [P, P, I64, I32, P]
    rng = np.random.default_rng(1)

    def draw(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape + (32,), dtype=np.int32))

    ok = True
    for chains, steps, lo, hi in ((1, 15, 0, 512), (7, 15, -300, 300), (9, 15, 0, 512),
                                  (6, 3, 0, 512), (5, 0, 0, 512), (130, 15, -300, 300),
                                  (513, 15, 0, 512)):
        first = [draw(lo, hi, chains) for _ in range(4)]
        rest = [draw(lo, hi, steps, chains) for _ in range(4)]
        for t in first:
            t[0] = 511
        for t in rest:
            t[:, 0] = 511
        if chains > 1:
            first[1][1] = first[0][1]  # y == x
        outs = [torch.empty((chains, steps + 1, 32), dtype=torch.int32) for _ in range(4)]
        if scan(*(t.data_ptr() for t in first + rest + outs), chains, steps, 0, None):
            raise SystemExit("scan_blocks launch failed")
        want = M._scan_blocks_plain(C.Point(*first), C.CachedPoint(*rest))
        equal = all(torch.equal(g, w) for g, w in zip(outs, want))
        ok &= equal
        print(f"scan_blocks {chains} x {steps} in [{lo}, {hi}): {'equal' if equal else 'DIFFERENT'}")
    for m in (1, 33, 100):
        for lo in (0, -511):
            a, b = draw(lo, 512, m), draw(lo, 512, m)
            a[0], b[0] = 511, 511 if lo == 0 else -511
            d = F.const("d", "cpu")
            out = torch.empty_like(a)
            results = []
            for x, x_step, y, y_step, want in ((a, 32, b, 32, F._mul_plain(a, b)),
                                               (a, 32, a, 32, F._mul_plain(a, a)),
                                               (a, 32, d, 0, F._mul_plain(a, d))):
                mul(x.data_ptr(), x_step, y.data_ptr(), y_step, out.data_ptr(), m, 0, None)
                results.append(torch.equal(out, want))
            pow22523(a.data_ptr(), out.data_ptr(), m, 0, None)
            results.append(torch.equal(out, F._pow22523_plain(a)))
            ok &= all(results)
            print(f"fe_mul (a b, a a, a d), fe_pow22523, m = {m} in [{lo}, 512): {results}")
    return ok & check_bls(libs) & check_sha256(libs)


def check_sha256(libs) -> bool:
    """B8 against its plain version and hashlib: n messages of the padding
    edges' lengths mixed (cycled from a different place for each n), after
    a prefix of 0 to 15 bytes, so that messages and thread blocks start at
    every alignment and the buffer ends off 16; n around the 32 messages
    of a thread block. The one-thread cycle probe on 1- and 8-block
    messages against hashlib, its two counters (the block loop, the
    rounds' chain) set."""
    import hashlib

    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.cuda import sha256 as S

    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = libs["sha256"].sha256_bytes_launch
    launch.argtypes = [P, I64, P, P, I64, I32, I32, P]
    cycles = libs["sha256"].sha256_cycles_launch
    cycles.argtypes = [P, I32, P, P, I32, P]
    edges = (0, 1, 55, 56, 63, 64, 65, 119, 120, 250, 251, 503)
    ok = True
    for n, prefix in ((1, 0), (1, 13), (31, 5), (32, 0), (33, 7), (70, 15), (97, 3)):
        lens = [edges[(i * 5 + n) % len(edges)] for i in range(n)]
        msgs = [bytes((7 * i + j) % 256 for j in range(k)) for i, k in enumerate(lens)]
        buf = torch.from_numpy(np.frombuffer(bytes(range(prefix)) + b"".join(msgs), np.uint8).copy())
        offsets = torch.from_numpy(np.cumsum([prefix] + lens).astype(np.int64))
        out = torch.empty((n, 32), dtype=torch.uint8)
        if launch(buf.data_ptr(), buf.numel(), offsets.data_ptr(), out.data_ptr(), n,
                  S._stage_bytes(n, max(lens)), 0, None):
            raise SystemExit("sha256_bytes launch failed")
        equal = torch.equal(out, S._sha256_bytes_plain(buf, offsets))
        same = all(bytes(out[i].tolist()) == hashlib.sha256(m).digest() for i, m in enumerate(msgs))
        ok &= equal and same
        print(f"sha256_bytes n = {n} after {prefix} bytes, {buf.numel()} bytes: "
              f"plain {equal}, hashlib {same}")
    for k in (55, 503):
        msg = bytes((3 * j + 1) % 256 for j in range(k))
        src = torch.from_numpy(np.frombuffer(msg, np.uint8).copy())
        out, clk = torch.empty(32, dtype=torch.uint8), torch.zeros(3, dtype=torch.int64)
        if cycles(src.data_ptr(), k, out.data_ptr(), clk.data_ptr(), 0, None):
            raise SystemExit("sha256_cycles launch failed")
        same = bytes(out.tolist()) == hashlib.sha256(msg).digest()
        ok &= same and bool((clk[:2] > 0).all())
        print(f"sha256_cycles {k} bytes: hashlib {same}, counters {bool((clk[:2] > 0).all())}")
    return ok


def check_bls(libs) -> bool:
    """K7a and K7b against their plain versions: real pairs at (2, 2) and
    (2, 4) (pad pairs beside them); p - 1 in every input with zero lines
    and pad pairs among the lanes; and K7b alone on lanes of p - 1, of
    one, and an item whose product is zero."""
    import torch

    from tendermint_tpu_torch.crypto import bls_math as B
    from tendermint_tpu_torch.crypto.cuda import bls_field as BF
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    miller = libs["bls_miller"].bls_miller_launch
    miller.argtypes = [P] * 7 + [I64, I32, P]
    final = libs["bls_final_exp"].bls_final_exp_launch
    final.argtypes = [P] * 3 + [I64, I64, I32, P]

    def run_miller(ins):
        m, npairs = ins[0].shape[:2]
        lanes = torch.empty((m, npairs, 6, 2, 49), dtype=torch.int32)
        miller(*(t.data_ptr() for t in ins), lanes.data_ptr(), m * npairs, 0, None)
        return lanes

    def run_final(f):
        m, npairs = f.shape[:2]
        okb = torch.empty(m, dtype=torch.bool)
        out = torch.empty((m, 6, 2, 49), dtype=torch.int32)
        final(f.data_ptr(), okb.data_ptr(), out.data_ptr(), m, npairs, 0, None)
        return okb, out

    q = B.hash_to_point_g2(b"emu")
    items = [[(B.g1_mul(B.G1_GEN, 5), q)], [(B.NEG_G1_GEN, B.g2_mul(q, 3)), (B.g1_mul(B.G1_GEN, 3), q)]]
    pm1 = torch.from_numpy(BF.int_to_limbs(B.P - 1))
    real = [torch.from_numpy(a) for a in BP.prepare_pairing_batch(items, 2, 2)[0]]
    wide = [torch.from_numpy(a) for a in BP.prepare_pairing_batch(items, 2, 4)[0]]
    worst = [t.clone() for t in real]
    for t in worst:
        t[...] = pm1
    for t in worst[2:]:
        t[:, 1] = 0  # item 1: zero lines; lane (1, 1) a pad pair
    worst[0][1, 1] = 0
    worst[1][1, 1] = torch.from_numpy(BF.ONE)
    ok = True
    for name, ins in (("real pairs (2, 2)", real), ("real pairs and pad pairs (2, 4)", wide),
                      ("p - 1, zero lines, a pad pair", worst)):
        lanes = run_miller(ins)
        want = BP._miller_plain(*ins)
        equal = torch.equal(lanes, want)
        okb, out = run_final(want)
        want_ok, want_out = BP._final_exp_plain(want)
        equal_b = torch.equal(out, want_out) and torch.equal(okb, want_ok)
        ok &= equal and equal_b
        print(f"bls_miller, bls_final_exp on {name}: {equal}, {equal_b} (ok {okb.tolist()})")
    # K7b alone: item 0 every lane p - 1, item 1 a zero lane beside one and
    # p - 1 (its product is zero), items 2 and 3 every lane one
    f = pm1.expand(4, 3, 6, 2, 49).clone()
    f[1, 0] = 0
    f[1, 1] = BF.f12_one()
    f[2:] = BF.f12_one()
    okb, out = run_final(f)
    want_ok, want_out = BP._final_exp_plain(f)
    equal_b = torch.equal(out, want_out) and torch.equal(okb, want_ok)
    zero = bool((out[1] == 0).all()) and not bool(okb[1])
    ok &= equal_b and zero
    print(f"bls_final_exp on p - 1, a zero product, all-one items: {equal_b}, zero kept {zero} "
          f"(ok {okb.tolist()})")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eager", action="store_true", help="run cp.async copies at issue")
    ap.add_argument("--tsan", action="store_true", help="build with ThreadSanitizer")
    args = ap.parse_args()
    flags, suffix = ["-O2"], ""
    if args.eager:
        flags, suffix = flags + ["-DEMU_EAGER"], suffix + "_eager"
    if args.tsan:
        flags, suffix = ["-O1", "-g", "-fsanitize=thread"] + flags[1:], suffix + "_tsan"
        tsan = subprocess.run(["g++", "-print-file-name=libtsan.so"], capture_output=True,
                              text=True, check=True).stdout.strip()
        if tsan not in os.environ.get("LD_PRELOAD", ""):
            build(flags, suffix)
            env = dict(os.environ, LD_PRELOAD=tsan, TSAN_OPTIONS="halt_on_error=1")
            return subprocess.run([sys.executable, __file__, "--checked-build", suffix],
                                  env=env).returncode
    build(flags, suffix)
    return 0 if check(suffix) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--checked-build"]:
        sys.exit(0 if check(sys.argv[2]) else 1)
    sys.exit(main())
