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
# argument types of each C entry (csrc/*.cu); every kernel entry returns
# its cudaGetLastError()
SIGNATURES = {
    # the sm90 synth_norm entries take a host array of the planned tile and its length
    "aw_synth_norm_fwd": [_P] * 9 + [_I] * 5 + [_P],
    "aw_synth_u": [_P] * 9 + [_I] * 5 + [_P],
    "aw_synth_norm_fwd_wmma": [_P] * 8 + [_I] * 4 + [_P],
    "aw_synth_norm_bwd": [_P] * 12 + [_I] * 5 + [_P],
    "aw_synth_norm_bwd_wmma": [_P] * 9 + [_I] * 4 + [_P],
    # the sm90 slab and dense GEMM entries take the planned tile (bm, bn) last
    "aw_band_analysis_fwd": [_P] * 3 + [_I] * 6 + [_P],
    "aw_band_analysis_fwd_wmma": [_P] * 3 + [_I] * 4 + [_P],
    "aw_band_analysis_bwd": [_P] * 3 + [_I] * 6 + [_P],
    "aw_band_analysis_bwd_wmma": [_P] * 3 + [_I] * 4 + [_P],
    # the sm90 detector chains take a host array of the planned tiles and its length
    "aw_detector_fwd": [_P] * 32 + [_I] * 4 + [_P],
    "aw_detector_fwd_wmma": [_P] * 29 + [_I] * 3 + [_P],
    "aw_detector_bwd": [_P] * 32 + [_I] * 4 + [_P],
    "aw_detector_bwd_wmma": [_P] * 30 + [_I] * 3 + [_P],
    "aw_reflect_analysis_fwd": [_P] * 4 + [_I] * 6 + [_P],
    "aw_reflect_analysis_fwd_wmma": [_P] * 3 + [_I] * 4 + [_P],
    "aw_reflect_analysis_bwd": [_P] * 4 + [_I] * 6 + [_P],
    "aw_reflect_analysis_bwd_wmma": [_P] * 4 + [_I] * 4 + [_P],
    # a host array of device pointers and its length, then the sizes
    "aw_iteration_fwd_wmma": [_P] + [_I] * 5 + [_P],
    "aw_iteration_bwd_wmma": [_P] + [_I] * 5 + [_P],
    # the sm90 chains also take a host array of the planned tiles and its length
    "aw_iteration_fwd_sm90": [_P, _I, _P, _I] + [_I] * 4 + [_P],
    "aw_iteration_bwd": [_P, _I, _P, _I] + [_I] * 4 + [_P],
    "aw_iteration_step": [_P, _I, _P, _I] + [_I] * 4 + [_F] * 4 + [_P],
    "aw_iteration_step_wmma": [_P] + [_I] * 5 + [_F] * 4 + [_P],
    "aw_step_epilogue": [_P] + [_I] * 4 + [_F] * 4 + [_P],
    "aw_shift_mm": [_P] * 3 + [_I] * 7 + [_P],
    "aw_shift_mm_wmma": [_P] * 3 + [_I] * 5 + [_P],
    "aw_slab_gemm_config": [_I] * 2 + [_P] * 3,
    "aw_slab_gemm": [_P] * 3 + [_I] * 13 + [_P],
    "aw_dense_gemm": [_P] * 3 + [_I] * 5 + [_P],
    "aw_dense_gemm_config": [_I] * 2 + [_P] * 3,
    "aw_synth_tiled_fwd": [_P] * 8 + [_I] * 7 + [_P],
    "aw_synth_tiled_reim": [_P] * 4 + [_I] * 3 + [_P],
    "aw_synth_tiled_gemm": [_P] * 6 + [_I] * 7 + [_P],
    "aw_synth_tiled_fwd_wmma": [_P] * 7 + [_I] * 5 + [_P],
    "aw_ola_fwd_stream": [_P] * 4 + [_I] * 5 + [_P],
    "aw_ola_bwd_stream": [_P] * 8 + [_I] * 5 + [_P],
    # the cluster variant takes the cluster size last
    "aw_ola_fwd_cluster": [_P] * 4 + [_I] * 6 + [_P],
    "aw_ola_bwd_cluster": [_P] * 5 + [_I] * 6 + [_P],
    "aw_ola_cluster_config": [_I] * 4 + [_P] * 5,
    # x, coefs, zi (null for none), y, then batch, length and the state
    # length (lfilter) or the sections (sosfilt)
    "aw_lfilter": [_P] * 4 + [_I] * 3 + [_P],
    "aw_sosfilt": [_P] * 4 + [_I] * 3 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # nvcc wall time, compile and link; 0.0 when already built
    log: str        # nvcc's output, with -Xptxas -v's register/smem lines (kept
                    # beside the library, so a load of a built library reads it too)


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
    log_file = so.with_suffix(".log")
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
            log_file.write_text(log)
            os.replace(tmp, so)
        finally:
            for leftover in (*objs, tmp):
                leftover.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    elif log_file.exists():
        log = log_file.read_text()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Build(lib, so, seconds, log)
