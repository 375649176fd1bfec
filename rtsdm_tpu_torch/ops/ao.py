"""SVAO math core (counterpart of rtsdm_tpu/ops/ao.py): the static config,
the quantized shift-radius levels, and the helpers the shift-mode SVAO
phases call (reference SVAO/Common.slang)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.sampling import (AO_KERNEL_HBAO, AO_KERNEL_VAO, DITHER_4X4,
                              sample_radius_table)

FLT_MAX = 3.402823466e38


@dataclasses.dataclass(frozen=True)
class VAOConfig:
    """VAOData (VAOData.slang:33-45) + the SVAO DefineList."""
    radius: float = 0.5
    exponent: float = 2.0
    thickness: float = 0.0
    ss_radius_cutoff: float = 6.0
    ss_max_radius: float = 512.0
    num_directions: int = 8
    kernel: int = AO_KERNEL_VAO
    resolution: tuple = (0, 0)        # (W, H) of the primary depth buffer
    low_resolution: tuple = (0, 0)    # SD map resolution without guard
    sd_guard: int = 0
    dual_ao: bool = False

    def radii(self):
        return sample_radius_table(self.num_directions, self.kernel)


def make_nonzero(v, eps):
    a = torch.clamp(torch.abs(v), min=eps)
    return torch.where(v >= 0, a, -a)


def finalize(cfg, avg_ao):
    """BasicAOData::finalize (Common.slang:326-330)."""
    if cfg.kernel == AO_KERNEL_HBAO:
        avg_ao = torch.clamp(1.0 - 2.0 * avg_ao, 0.0, 1.0)
    return torch.clamp(avg_ao, 0.0, 1.0) ** cfg.exponent


# The ring samples at pixel + radius_px * (sin a, cos a); quantizing the
# radius onto a static level table turns every fetch into a table-driven
# shift — exact for radii up to SHIFT_EXACT_RADII pixels, log-spaced above
# (SHIFT_LOG_LEVELS = 20 is critical to quality; do not change it).
SHIFT_EXACT_RADII = 12
SHIFT_LOG_LEVELS = 20


def shift_radius_levels(max_radius: float) -> np.ndarray:
    """Static table of quantized sampling radii (pixels), float32."""
    exact = np.arange(1, SHIFT_EXACT_RADII + 1, dtype=np.float64)
    if max_radius > SHIFT_EXACT_RADII:
        logs = np.geomspace(SHIFT_EXACT_RADII, max_radius,
                            SHIFT_LOG_LEVELS + 1)[1:]
        return np.concatenate([exact, logs]).astype(np.float32)
    return exact.astype(np.float32)


def level_bounds(levels) -> np.ndarray:
    """float32 geometric midpoints between consecutive levels (computed in
    float64, then rounded — the bounds every level lookup compares with)."""
    lv = np.asarray(levels, np.float64)
    return np.sqrt(lv[:-1] * lv[1:]).astype(np.float32)


def shift_level_index(levels, r_px):
    """Per-pixel nearest-level index (int32): the number of bounds below
    r_px, compared in float32 (PyTorch rounds a Python scalar to the
    tensor's float32 before comparing)."""
    idx = torch.zeros(r_px.shape, dtype=torch.int32, device=r_px.device)
    for b in level_bounds(levels):
        idx += (r_px > float(b)).to(torch.int32)
    return idx


def dither_noise_for(height: int, width: int, device="cpu"):
    """The 4x4 wrap-sampled rotation noise (SVAO.cpp:663-688), tiled."""
    reps = (-(-height // 4), -(-width // 4))
    return torch.as_tensor(np.tile(DITHER_4X4, reps)[:height, :width].copy(),
                           device=device)
