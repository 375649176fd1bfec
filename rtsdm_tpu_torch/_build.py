"""Builds the package's native code on first use and loads it with ctypes.

* CUDA kernels: each ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers it
  may include) is compiled by its own ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface (no PyTorch
  headers, so a build takes seconds); the ``nvcc`` processes are started
  together. ``--fmad=false`` and no fast math keep every kernel
  bit-compatible with its plain PyTorch version, which evaluates the same
  expressions one rounded operation at a time.
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

# C entry points of each kernel source: name -> argument types. Every entry
# but rtsdm_svao_resolve_layout launches on the given stream (last argument)
# and returns cudaGetLastError().
KERNEL_SIGNATURES = {
    "raster.cu": {
        "rtsdm_raster_blocks": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                _P, _F, _P, _P, _P, _P, _P],
        "rtsdm_fetch_attributes": [_P, _P, _P, _I, _I, _I, _P, _P],
    },
    "fetch.cu": {
        "rtsdm_fetch_directions": [_P] * 5 + [_I] * 7 + [_P, _P],
        "rtsdm_fetch_sd_packed": [_P] * 5 + [_I] * 6 + [_P, _P],
        "rtsdm_fetch_sd_strided": [_P] * 5 + [_I] * 7 + [_P, _P],
        "rtsdm_fetch_taps_same_class": [_P] * 3 + [_I] * 8 + [_P, _P],
    },
    "sd_trace.cu": {
        "rtsdm_sd_trace": [_P] * 6 + [_I] * 7 + [_F, _P, _I, _P, _P, _P],
        "rtsdm_sd_trace_resident": [_P] * 4 + [_I] * 8 + [_F, _P, _I, _P,
                                                          _P, _P],
        "rtsdm_sd_keys": [_P, _P, _P, _I, _P, _P, _P],
    },
    "warp.cu": {
        "rtsdm_warp_resample": [_P, _P, _P] + [_I] * 7 + [_P, _P],
    },
    "any_hit.cu": {
        "rtsdm_any_hit": [_P] * 5 + [_I] * 3 + [_P, _P, _P],
    },
    "raster_sd.cu": {
        "rtsdm_raster_stochastic": [_P] * 7 + [_I] * 6 + [_F, _P, _I, _P,
                                                          _P, _P],
    },
    "svao_resolve.cu": {
        # a pointer to ops/resolve_cuda.ResolveArgs, vao, packed, stream
        "rtsdm_svao_resolve": [_P, _I, _I, _P],
        # launches nothing: ResolveArgs' size and field offsets
        "rtsdm_svao_resolve_layout": [_P, _I],
    },
}

_kernel_fns = None
_scenekit_lib = None
BUILD_SECONDS = {}
# launches of each C entry point (or mode of one) since the last
# LAUNCHES.clear()
LAUNCHES = collections.Counter()


def _digest(paths, flags) -> str:
    h = hashlib.sha1()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(jobs) -> float:
    """Run each (command, out) job whose `out` does not exist yet, all side
    by side, each writing a temporary file that is renamed to `out`;
    returns the build seconds."""
    jobs = [(cmd, out) for cmd, out in jobs if not out.exists()]
    if not jobs:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = []
    for cmd, out in jobs:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [*cmd, "-o", str(tmp)]
        running.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for cmd, tmp, out, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"build failed ({' '.join(cmd)}):\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
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


def kernel_library() -> dict:
    """The C entry points of the CUDA kernels, by name (each csrc/*.cu is
    built on first use)."""
    global _kernel_fns
    if _kernel_fns is None:
        headers = sorted(CSRC_DIR.glob("*.cuh"))
        outs = {src: BUILD_DIR / (f"librtsdm_{src.stem}_"
                                  f"{_digest([src, *headers], NVCC_FLAGS)}"
                                  ".so")
                for src in sorted(CSRC_DIR.glob("*.cu"))}
        nvcc = nvcc_path()
        BUILD_SECONDS["kernels"] = _compile(
            [([nvcc, *NVCC_FLAGS, str(src)], out)
             for src, out in outs.items()])
        fns = {}
        for src, out in outs.items():
            lib = ctypes.CDLL(str(out))
            for name, argtypes in KERNEL_SIGNATURES[src.name].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        _kernel_fns = fns
    return _kernel_fns


def scenekit_library():
    """The loaded scenekit helper (morton codes), built by g++ on first use."""
    global _scenekit_lib
    if _scenekit_lib is None:
        out = BUILD_DIR / (f"libscenekit_"
                           f"{_digest([SCENEKIT_SRC], GXX_FLAGS)}.so")
        BUILD_SECONDS["scenekit"] = _compile(
            [(["g++", *GXX_FLAGS, str(SCENEKIT_SRC)], out)])
        lib = ctypes.CDLL(str(out))
        lib.scenekit_morton_codes.argtypes = [_P, ctypes.c_int64, _P, _P, _P]
        lib.scenekit_morton_codes.restype = None
        _scenekit_lib = lib
    return _scenekit_lib


def launch(name: str, *args, key: str | None = None) -> None:
    """Call C entry point `name`, raise on a CUDA error code, and count the
    launch in LAUNCHES[key or name] (the one place a kernel launch is
    counted; `key` splits one entry point's count by mode)."""
    err = kernel_library()[name](*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[key or name] += 1


def ptr(t) -> int:
    """Device pointer of a contiguous tensor, for a ctypes argument."""
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
