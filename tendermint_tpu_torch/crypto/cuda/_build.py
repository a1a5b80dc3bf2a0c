"""Build and load the hand-written CUDA kernels in csrc/.

Each `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for `sm_90a` into a shared library with a plain C interface,
and loaded with ctypes. The libraries go under `build/torch_ext/<key>/` at
the root of the checkout, where `<key>` hashes the sources and the flags,
so a second process reuses them and an edited source rebuilds. Nothing is
built at import: the first launch of any kernel builds them all.

The process's first call is its attach (crypto/backend_telemetry.py): CUDA
initialisation plus the loads, built first where a library is missing;
each library loaded counts as a compile-cache hit (found on disk) or
miss (built by nvcc here).

Every C launcher takes its pointers, sizes, the CUDA device index and the
stream, makes the device current only if another one is
(csrc/launch.cuh), launches on that stream, and returns
`cudaGetLastError()`; `Kernel.__call__` raises if that is not 0. There
is no fallback: a kernel that does not build or launch is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: every kernel the port defines, by name (filled as modules import)
KERNELS: dict[str, "Kernel"] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build printed (ptxas register/spill report), per source
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def nvcc_command(src, out) -> list[str]:
    """The nvcc command that builds the CUDA source `src` (which may
    include csrc/'s headers) into the shared library `out`."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu that is not built yet, in parallel; load
    them all. Returns {source stem: library path}. Raises on any failure.
    The first call in a process is its attach (CUDA initialisation and
    the loads), recorded in crypto/backend_telemetry.py."""
    from .. import backend_telemetry as bt

    with _lock:
        if _libs:
            return _build_and_load(bt)
        t0 = time.perf_counter()
        try:
            torch.cuda.init()
            paths = _build_and_load(bt)
        except Exception as e:
            bt.record_attach_attempt(time.perf_counter() - t0, False, kind="cuda", error=repr(e))
            raise
        bt.record_attach_attempt(time.perf_counter() - t0, True, kind="cuda")
        return paths


def _build_and_load(bt) -> dict[str, Path]:
    """build_all's work; the caller holds `_lock`."""
    out_dir = BUILD_ROOT / _build_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        procs.append(
            (src, lib, tmp, subprocess.Popen(
                nvcc_command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build sees whole files
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    built = {src.stem for src, _lib, _tmp, _proc in procs}
    paths = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources}
    for stem, path in paths.items():
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(path))
            bt.record_compile_cache(stem not in built)
    return paths


class Kernel:
    """One CUDA launcher: its C symbol in `lib<source>.so`, its ctypes
    argument types, and `launches`, the number of times it was launched
    (a plain integer; reset it by assignment). Launches from any thread
    count (the block-sync reactor verifies its ranges in a worker
    thread), under one lock so none is lost."""

    def __init__(self, name: str, source: str, argtypes: list, replaces: str):
        self.name = name
        self.source = source  # csrc/<source>.cu
        self.replaces = replaces  # the Pallas function it replaces (file:line)
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _load(self):
        if self.source not in _libs:
            build_all()
        fn = getattr(_libs[self.source], f"{self.name}_launch")
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, *args) -> None:
        fn = self._fn or self._load()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        with _count_lock:
            self.launches += 1


def stream_args(t) -> tuple[int, int]:
    """(device index, raw stream handle) of PyTorch's current stream on
    the device of CUDA tensor `t`: what every launcher takes last. Read
    straight from PyTorch's C layer, with no Stream object built per
    launch."""
    index = t.get_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
