"""Deterministic sample tables (counterpart of rtsdm_tpu/utils/sampling.py).

  - sample radii: van-der-Corput radical inverse + kernel CDF inversion
    (reference SVAO/GenPoints.py:22-27),
  - dither rotation noise: 4x4 ordered-dither matrix (SVAO.cpp:663-688),
  - SD-map sub-texel jitter: 16-entry table (StochasticDepthMapRT/
    Jitter.slangh:20-50).
"""
from __future__ import annotations

import math

import numpy as np
import torch

AO_KERNEL_VAO = 0
AO_KERNEL_HBAO = 1


def van_der_corput(n: int, base: int = 2) -> float:
    result, denom = 0.0, 1
    while n > 0:
        denom *= base
        n, rem = divmod(n, base)
        result += rem / denom
    return result


def sample_radius_table(num_directions: int, kernel: int) -> np.ndarray:
    """Normalized radius per direction (GenPoints.py: VAO sqrt(1-rng^(2/3)),
    HBAO 2*asin(rng^1.25)/pi; rng = vdc(i) for i in [N, 2N))."""
    rngs = [van_der_corput(i) for i in range(num_directions,
                                             2 * num_directions)]
    if kernel == AO_KERNEL_VAO:
        vals = [(1.0 - r ** (2.0 / 3.0)) ** 0.5 for r in rngs]
    else:
        vals = [2.0 * math.asin(r ** 1.25) / math.pi for r in rngs]
    return np.asarray(vals, np.float32)


# 4x4 ordered-dither matrix normalized to [0,1), quantized like the
# reference's unorm8 texture (SVAO.cpp:670-674).
DITHER_4X4 = (np.floor(np.array([
    [0.0, 8.0, 2.0, 10.0],
    [12.0, 4.0, 14.0, 6.0],
    [3.0, 11.0, 1.0, 9.0],
    [15.0, 7.0, 13.0, 5.0],
], np.float32) / 16.0 * 255.0) / 255.0).astype(np.float32)


# 4x4 sub-texel jitter positions (Jitter.slangh:20), data constants of the
# technique, kept verbatim.
JITTER_4X4 = np.array([
    [0.6483604982495308, 0.914070401340723],
    [0.7279119342565536, 0.1037941575050354],
    [0.48886989802122116, 0.699178121984005],
    [0.3848271369934082, 0.25951504334807396],
    [0.1555836834013462, 0.8020274639129639],
    [0.2205628715455532, 0.2412630058825016],
    [0.9962188489735126, 0.5846633277833462],
    [0.8776040785014629, 0.3954884633421898],
    [0.9271227307617664, 0.831196017563343],
    [0.9490576796233654, 0.14202157780528069],
    [0.20916065946221352, 0.5476771481335163],
    [0.16468944773077965, 0.4869129806756973],
    [0.43544455617666245, 0.9515445046126842],
    [0.44085410237312317, 0.011881716549396515],
    [0.7173641100525856, 0.6695209294557571],
    [0.6563677340745926, 0.35924511030316353],
], np.float32)


def random_jitter(px, py, enabled: bool = True):
    """Per-SD-texel sub-texel jitter [..., 2] for arbitrary int index
    tensors (Jitter.slangh:27-50)."""
    if not enabled:
        return torch.full(px.shape + (2,), 0.5, device=px.device)
    idx = (py % 4) * 4 + (px % 4)
    return torch.as_tensor(JITTER_4X4, device=px.device)[idx]


def jitter_grid(h: int, w: int, enabled: bool = True, x0: int = 0,
                y0: int = 0, device="cpu"):
    """[h, w, 2] sub-texel jitter for the contiguous grid starting at
    (x0, y0): the 4x4 table tiled."""
    if not enabled:
        return torch.full((h, w, 2), 0.5, device=device)
    tab = np.asarray(JITTER_4X4, np.float32).reshape(4, 4, 2)  # [py, px, 2]
    tab = np.roll(tab, -(int(x0) % 4), axis=1)
    tile = np.tile(tab, ((h + 7) // 4, (w + 3) // 4, 1))
    o = int(y0) % 4
    return torch.as_tensor(tile[o:o + h, :w].copy(), device=device)
