"""The device rule of the package's entry points: they build on the GPU
unless the caller asks for the CPU. Without a CUDA device an entry point
raises instead of quietly running on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is no
    CUDA device (pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtsdm_tpu_torch runs on an NVIDIA GPU by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
