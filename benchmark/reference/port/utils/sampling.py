"""Deterministic sample tables (counterpart of rtsdm_tpu/utils/sampling.py).

  - sample radii: van-der-Corput radical inverse + kernel CDF inversion
    (reference SVAO/GenPoints.py:22-27),
  - dither rotation noise: 4x4 ordered-dither matrix (SVAO.cpp:663-688),
  - SD-map sub-texel jitter: 16-entry table (StochasticDepthMapRT/
    Jitter.slangh:20-50),
  - camera sample patterns of the G-buffer passes (SampleGenerators).
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


def jitter_grid(h: int, w: int, enabled: bool = True, x0: int = 0,
                y0: int = 0, *, device):
    """[h, w, 2] sub-texel jitter for the contiguous grid starting at
    (x0, y0): the 4x4 table tiled."""
    if not enabled:
        return torch.full((h, w, 2), 0.5, device=device)
    tab = np.asarray(JITTER_4X4, np.float32).reshape(4, 4, 2)  # [py, px, 2]
    tab = np.roll(tab, -(int(x0) % 4), axis=1)
    tile = np.tile(tab, ((h + 7) // 4, (w + 3) // 4, 1))
    o = int(y0) % 4
    return torch.as_tensor(tile[o:o + h, :w].copy(), device=device)


_DX8_PATTERN = np.asarray(
    [[1, -3], [-1, 3], [5, 1], [-3, -5],
     [-5, 5], [-7, -1], [3, 7], [7, -7]], np.float32) / 16.0


def sample_pattern_offsets(pattern: str, sample_count: int) -> np.ndarray:
    """[N, 2] per-frame camera sub-pixel offsets in pixels, in [-0.5, 0.5)
    (reference Utils/SampleGenerators: DxSamplePattern.cpp kPattern,
    HaltonSamplePattern halton(i, 2/3) - 0.5, StratifiedSamplePattern's
    jittered bins from a fixed seed). The G-buffer passes take offset
    frame_index % N as the camera jitter."""
    if pattern in ("Center", None, ""):
        return np.zeros((1, 2), np.float32)
    if pattern == "DirectX":
        return _DX8_PATTERN.copy()
    n = max(1, int(sample_count))
    if pattern == "Halton":
        return np.asarray([[van_der_corput(i + 1, 2) - 0.5,
                            van_der_corput(i + 1, 3) - 0.5]
                           for i in range(n)], np.float32)
    if pattern == "Stratified":
        bx = int(np.sqrt(n))
        by = n // bx
        while bx * by != n:
            bx += 1
            by = n // bx
        rng = np.random.default_rng(0)
        i = np.arange(n)
        jit = rng.random((n, 2)).astype(np.float32)
        x = ((i % bx) + jit[:, 0]) / bx - 0.5
        y = ((i // bx) + jit[:, 1]) / by - 0.5
        return np.stack([x, y], -1).astype(np.float32)
    raise ValueError(f"unknown samplePattern '{pattern}'")


def stratified_coverage_tables(num_samples: int) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Stratified coverage-mask tables (StochasticDepthMapRT.cpp:79-124):
    lookup lists every num_samples-bit mask grouped by popcount, and
    indices[R] is the offset of the group with R bits set."""
    masks_by_count = [[] for _ in range(num_samples + 1)]
    for m in range(1 << num_samples):
        masks_by_count[bin(m).count("1")].append(m)
    lookup = []
    indices = [0]
    for group in masks_by_count:
        lookup.extend(group)
        indices.append(len(lookup))
    return (np.asarray(indices, np.uint32), np.asarray(lookup, np.uint32))


def coverage_mask_select(alpha: float, rng, rng2, k: int):
    """Stratified alpha-to-coverage mask (Common.slangh:117-131): r_cnt =
    floor(alpha*k + rng) set bits (a float32 add), the mask picked from the
    popcount-r_cnt group of stratified_coverage_tables by rng2 (truncated
    float32 product). rng, rng2: float32 in [0, 1). Returns int32 k-bit
    masks."""
    idx_np, lut_np = stratified_coverage_tables(k)
    r_cnt = torch.clamp(torch.floor(alpha * k + rng).to(torch.int32), 0, k)
    sel = torch.zeros_like(r_cnt)
    for rr in range(1, k):
        lo, hi = int(idx_np[rr]), int(idx_np[rr + 1])
        sel = torch.where(r_cnt == rr,
                          lo + (rng2 * (hi - lo)).to(torch.int32), sel)
    lut = torch.as_tensor(lut_np.astype(np.int32), device=sel.device)
    mask = torch.where((sel >= 0) & (sel < lut.numel()),
                       lut[sel.clamp(0, lut.numel() - 1).long()], 0)
    mask = torch.where(r_cnt >= k, (1 << k) - 1, mask)
    return torch.where(r_cnt == 0, 0, mask).to(torch.int32)
