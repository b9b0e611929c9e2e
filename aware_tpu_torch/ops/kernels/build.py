"""Build of the port's CUDA kernels (one nvcc per source) and their ctypes binding.

Each source under ``aware_tpu_torch/csrc`` (``*.cu``; the ``*.cuh``
headers they share are included) compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a``, one nvcc per source, all
started together; one more nvcc links the objects into a shared library
with a plain C interface (no PyTorch headers, so the build takes
seconds).  The library lands in ``aware_tpu_torch/_build/`` under a name
that carries the hash of the sources, headers and flags, so an edited
source rebuilds.  The build runs at first use, never at import.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each C entry (csrc/*.cu); every entry returns its
# cudaGetLastError()
SIGNATURES = {
    "aw_synth_norm_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "aw_synth_norm_bwd": [_P] * 9 + [_I] * 4 + [_P],
    "aw_band_analysis_fwd": [_P] * 3 + [_I] * 4 + [_P],
    "aw_band_analysis_bwd": [_P] * 3 + [_I] * 4 + [_P],
    "aw_detector_fwd": [_P] * 29 + [_I] * 3 + [_P],
    "aw_detector_bwd": [_P] * 30 + [_I] * 3 + [_P],
    "aw_reflect_analysis_fwd": [_P] * 3 + [_I] * 4 + [_P],
    "aw_reflect_analysis_bwd": [_P] * 4 + [_I] * 4 + [_P],
    # a host array of device pointers and its length, then the sizes
    "aw_iteration_fwd": [_P] + [_I] * 5 + [_P],
    "aw_iteration_bwd": [_P] + [_I] * 5 + [_P],
    "aw_iteration_step": [_P] + [_I] * 5 + [_F] * 4 + [_P],
    "aw_step_epilogue": [_P] + [_I] * 4 + [_F] * 4 + [_P],
    "aw_shift_mm": [_P] * 3 + [_I] * 5 + [_P],
    "aw_synth_tiled_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "aw_ola_fwd": [_P] * 4 + [_I] * 3 + [_P],
    "aw_ola_bwd": [_P] * 8 + [_I] * 3 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # nvcc wall time, compile and link; 0.0 when already built
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
    for src in sorted(SOURCE_DIR.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libaware_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            procs = [
                subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)
            ]
            log = "".join(proc.communicate()[0] for proc in procs)
            failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            link = subprocess.run(
                [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            log += link.stdout + link.stderr
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
            os.replace(tmp, so)
        finally:
            for leftover in (*objs, tmp):
                leftover.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Build(lib, so, seconds, log)
