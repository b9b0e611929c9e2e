"""Build of the port's CUDA kernels: one nvcc call, a ctypes binding.

All sources under ``aware_tpu_torch/csrc`` compile in one
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with
a plain C interface (no PyTorch headers, so the build takes seconds).  The
library lands in ``aware_tpu_torch/_build/`` under a name that carries the
hash of the sources and flags, so an edited source rebuilds.  The build
runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE = pathlib.Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry (csrc/roundtrip.cu); every entry returns
# its cudaGetLastError()
SIGNATURES = {
    "aw_synth_norm_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "aw_synth_norm_bwd": [_P] * 9 + [_I] * 4 + [_P],
    "aw_band_analysis_fwd": [_P] * 3 + [_I] * 4 + [_P],
    "aw_band_analysis_bwd": [_P] * 3 + [_I] * 4 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str        # nvcc's output, with -Xptxas -v's register/smem lines


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile (if needed) and load the kernel library."""
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libaware_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Build(lib, so, seconds, log)
