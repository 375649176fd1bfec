"""The device rule of the package's entry points: they build on the GPU
unless the caller asks for the CPU. Without a CUDA device an entry point
raises instead of quietly running on the CPU. Small constants the
frame's code needs on its device are made once (device_constant); each
miss runs under the profiler scope tables.svao, so a trace counts them."""
from __future__ import annotations

import functools

import torch

from ..core.profiler import profile_scope


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is no
    CUDA device (pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtsdm_tpu_torch runs on an NVIDIA GPU by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


def device_constant(values, dtype, device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device) for a number or a
    tuple of numbers, made once per (values, dtype, device) and shared:
    callers never write to it. A tensor made from host values is a
    blocking copy to the GPU, which waits for every launch queued before
    it; a constant of the frame's code comes from here instead."""
    return _constant(values, dtype, torch.device(device))


@functools.lru_cache(maxsize=64)
def _constant(values, dtype, device):
    with profile_scope("tables.svao"):
        return torch.tensor(values, dtype=dtype, device=device)
