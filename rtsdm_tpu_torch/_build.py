"""Builds the package's native code on first use and loads it with ctypes.

* CUDA kernels: every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
  into one shared library with a plain C interface (no PyTorch headers, so
  a build takes seconds). ``--fmad=false`` and no fast math keep every
  kernel bit-compatible with its plain PyTorch version, which evaluates the
  same expressions one rounded operation at a time.
* ``scenekit``: the scene-build helper of the reference package
  (``rtsdm_tpu/native/scenekit.cpp``, read as a source file only — importing
  ``rtsdm_tpu`` would import jax), compiled by ``g++``.

Outputs go to ``build/rtsdm_tpu_torch/`` beside the package, named by a hash
of their sources and flags, so a stale library is never loaded. Each build
writes a temporary file and renames it into place, so concurrent test
workers never load a half-written library.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rtsdm_tpu_torch"
SCENEKIT_SRC = PKG_DIR.parent / "rtsdm_tpu" / "native" / "scenekit.cpp"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points of the kernel library: name -> argument types. Every entry
# launches on the given stream (last argument) and returns cudaGetLastError().
KERNEL_SIGNATURES = {
    # raster.cu
    "rtsdm_raster_blocks": [_P, _P, _P, _I, _I, _I, _I, _F, _F,
                            _P, _P, _P, _P, _P],
    "rtsdm_fetch_attributes": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # fetch.cu
    "rtsdm_fetch_directions": [_P] * 5 + [_I] * 7 + [_P, _P],
    "rtsdm_fetch_sd_packed": [_P] * 5 + [_I] * 7 + [_P, _P],
    # sd_trace.cu
    "rtsdm_sd_trace": [_P] * 4 + [_I] * 6 + [_P, _P],
    "rtsdm_sd_keys": [_P, _P, _P, _I, _P, _P, _P],
}

_kernel_lib = None
_scenekit_lib = None
BUILD_SECONDS = {}
# launches of each C entry point since the last LAUNCHES.clear()
LAUNCHES = collections.Counter()


def _digest(paths, flags) -> str:
    h = hashlib.sha1()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(cmd_head, flags, sources, out: Path) -> float:
    """Compile into `out` unless it already exists; returns build seconds."""
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    cmd = [*cmd_head, *flags, *map(str, sources), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"build failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built only on a "
                       "machine with the CUDA toolkit")


def kernel_library():
    """The loaded CUDA kernel library (built from csrc/*.cu on first use)."""
    global _kernel_lib
    if _kernel_lib is None:
        sources = sorted(CSRC_DIR.glob("*.cu"))
        out = BUILD_DIR / f"librtsdm_kernels_{_digest(sources, NVCC_FLAGS)}.so"
        BUILD_SECONDS["kernels"] = _compile([nvcc_path()], NVCC_FLAGS,
                                            sources, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in KERNEL_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernel_lib = lib
    return _kernel_lib


def scenekit_library():
    """The loaded scenekit helper (morton codes), built by g++ on first use."""
    global _scenekit_lib
    if _scenekit_lib is None:
        out = BUILD_DIR / (f"libscenekit_"
                           f"{_digest([SCENEKIT_SRC], GXX_FLAGS)}.so")
        BUILD_SECONDS["scenekit"] = _compile(["g++"], GXX_FLAGS,
                                             [SCENEKIT_SRC], out)
        lib = ctypes.CDLL(str(out))
        lib.scenekit_morton_codes.argtypes = [_P, ctypes.c_int64, _P, _P, _P]
        lib.scenekit_morton_codes.restype = None
        _scenekit_lib = lib
    return _scenekit_lib


def launch(name: str, *args) -> None:
    """Call C entry point `name`, raise on a CUDA error code, and count the
    launch in LAUNCHES[name] (the one place a kernel launch is counted)."""
    err = getattr(kernel_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[name] += 1


def ptr(t) -> int:
    """Device pointer of a contiguous tensor, for a ctypes argument."""
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
