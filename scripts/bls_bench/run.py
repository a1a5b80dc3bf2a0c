#!/usr/bin/env python3
"""Latency of the BLS12-381 pairing kernels' primitives on one GPU.

    python3 scripts/bls_bench/run.py

Builds bench.cu (beside this file) against
tendermint_tpu_torch/crypto/cuda/csrc/bls12_381.cuh with the kernels' own
nvcc command (`_build.nvcc_command`: sm_90a, the same flags) into
build/bls_bench/ at the root of the checkout, and prints one JSON
object: cycles per call (clock64 around a loop of dependent calls in one
block) of `fp_mul`, of a Wide sum of 7 and of 19 terms with its
reduction, of `fp_inv` (also in CUDA-event ms for 20 calls), of a
`__syncthreads` at 32 to 512 threads, and of each Fq12 operation at the
thread counts the kernels run it with; the instruction count of each
function (cuobjdump -sass); the card's name, power limit and SM clock.
Inputs are 24 fixed random values below p. Exits non-zero without a card.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import random
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(ROOT, "build", "bls_bench")
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
OPS = ["f12_mul", "cyclotomic_sqr", "f12_sqr", "f12_mul_line", "frob", "frob2", "conj"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bls_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tendermint_tpu_torch.crypto.cuda import _build

    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libbench.so")
    cmd = _build.nvcc_command(os.path.join(HERE, "bench.cu"), lib)
    build = subprocess.run(cmd, capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    sass = subprocess.run([os.path.join(os.path.dirname(cmd[0]), "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True).stdout
    instructions = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", f)
        instructions[f.split("\n", 1)[0].strip()] = {
            "total": len(ops), "top": dict(collections.Counter(ops).most_common(6))}

    L = ctypes.CDLL(lib)
    L.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int]
    rng = random.Random(20261017)
    vals = [rng.randrange(P) for _ in range(24)]
    io = torch.tensor([(v >> (28 * i)) & 0xFFFFFFF for v in vals for i in range(14)],
                      dtype=torch.int64).to(torch.int32).cuda()
    cyc = torch.zeros(2, dtype=torch.int64).cuda()

    def cycles(which, n, arg=0, threads=1):
        if L.run(which, io.data_ptr(), cyc.data_ptr(), n, arg, threads):
            raise RuntimeError("bench kernel failed")
        return cyc[0].item() / n

    res = {"fp_mul_cycles": cycles(0, 1000)}
    for terms in (6, 18):
        res[f"wide_{terms + 1}_terms_cycles"] = cycles(1, 1000, terms)
    res["fp_inv_cycles"] = cycles(2, 20)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cycles(2, 20)
    end.record()
    torch.cuda.synchronize()
    res["fp_inv_x20_ms"] = start.elapsed_time(end)
    for th in (32, 64, 128, 512):
        res[f"syncthreads_{th}_cycles"] = cycles(3, 1000, 0, th)
    for op, name in enumerate(OPS):
        for th in ((64,) if name in ("f12_sqr", "f12_mul_line") else (128, 512)):
            res[f"{name}_{th}_threads_cycles"] = cycles(4, 200, op, th)
    res["instructions"] = instructions
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
