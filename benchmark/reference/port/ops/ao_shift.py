"""Shift-mode SVAO sampling (counterpart of rtsdm_tpu/ops/ao_shift.py).

The per-pixel dither rotation is periodic on a 4x4 grid, so the image
deinterleaves into 16 rotation classes; within a class the screen direction
of ring direction i is one static vector. The sample radius is quantized
onto a static level table (ops/ao.py), so every depth fetch is a static
shift picked per texel by its level. With stochMapDivisor 4 the SD texel of
(pixel + offset) is the quarter coordinate plus a static offset.

fetch_direction and fetch_sd_direction are the per-direction plain forms;
ops/fetch_cuda.py serves all directions at once (K3, K4) and uses them as
its plain versions.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.sampling import DITHER_4X4, JITTER_4X4
from . import ao as A


def class_angles():
    """Rotation angle per 4x4 dither class (randRotation = noise * 2*pi with
    the reference's 3.141, Common.slang:311)."""
    return (DITHER_4X4.reshape(16) * 2.0 * 3.141).astype(np.float32)


def screen_dir(alpha: float, theta: float):
    """Static screen-space unit direction of ring direction `alpha` under
    class rotation `theta` (exact at the screen centre)."""
    dx, dy = math.sin(alpha), math.cos(alpha)
    sx, sy = math.sin(theta), math.cos(theta)
    vx = sx * dx - sy * dy
    vy = sy * dx + sx * dy
    return vx, -vy


def offset_tables(cfg, max_radius_px: float):
    """(levels, offs, radii): offs[i][c][l] = (dy, dx) integer pixel offset
    for direction i, dither class c, radius level l."""
    levels = A.shift_radius_levels(max_radius_px)
    thetas = class_angles()
    nd = cfg.num_directions
    alphas = [(i / nd) * 2.0 * 3.141 for i in range(nd)]
    offs = []
    for i in range(nd):
        per_class = []
        for c in range(16):
            ux, uy = screen_dir(alphas[i], float(thetas[c]))
            per_class.append([(int(round(r * uy)), int(round(r * ux)))
                              for r in levels])
        offs.append(per_class)
    return levels, offs, cfg.radii()


def deinterleave(tex):
    """[H,W(,C)] -> [16, H/4, W/4(,C)], class = (y%4)*4 + x%4."""
    h, w = tex.shape[:2]
    t = tex.reshape((h // 4, 4, w // 4, 4) + tex.shape[2:])
    t = torch.movedim(t, (1, 3), (0, 1))
    return t.reshape((16, h // 4, w // 4) + tex.shape[2:])


def interleave(planes, h: int, w: int):
    t = planes.reshape((4, 4) + planes.shape[1:])
    t = torch.movedim(t, (0, 1), (1, 3))
    return t.reshape((h, w) + planes.shape[3:])


def pad_planes(planes, pad: int):
    """Edge-replicate pad [16, qh, qw] planes by `pad` on both spatial axes
    so every per-level fetch is one static slice."""
    return torch.nn.functional.pad(planes, (pad, pad, pad, pad),
                                   mode="replicate")


def fetch_direction(padded_planes, pad: int, lvl_planes, offs_i, qh: int,
                    qw: int):
    """Ring direction i: per class, select among the level-shifted slices
    (a full-res offset from class c lands in class c2 = ((cy+dy)%4)*4 +
    (cx+dx)%4 at quarter offset ((cy+dy)//4, (cx+dx)//4), clamped to the
    pad). padded_planes [16, qh+2p, qw+2p], lvl_planes [16, qh, qw] int32.
    Returns [16, qh, qw]."""
    out = []
    for c in range(16):
        cy, cx = c // 4, c % 4
        acc = torch.zeros((qh, qw), dtype=padded_planes.dtype,
                          device=padded_planes.device)
        for l, (dy, dx) in enumerate(offs_i[c]):
            c2 = ((cy + dy) % 4) * 4 + (cx + dx) % 4
            y = pad + max(-pad, min(pad, (cy + dy) // 4))
            x = pad + max(-pad, min(pad, (cx + dx) // 4))
            acc = torch.where(lvl_planes[c] == l,
                              padded_planes[c2, y:y + qh, x:x + qw], acc)
        out.append(acc)
    return torch.stack(out)


def _level_radius_formula(levels, lvl):
    exact_n = A.SHIFT_EXACT_RADII
    if len(levels) <= exact_n:
        return (lvl + 1).to(torch.float32)
    ratio = float(levels[-1] / levels[-2])
    log_r0 = math.log(float(levels[exact_n]))
    log_step = math.log(ratio)
    r_log = torch.exp(log_r0 + (lvl - exact_n).to(torch.float32) * log_step)
    return torch.where(lvl < exact_n, (lvl + 1).to(torch.float32), r_log)


@functools.lru_cache(maxsize=16)
def _level_radius_table(levels: tuple, device) -> torch.Tensor:
    """Every level's radius, evaluated on the host and moved to `device`."""
    lvl = torch.arange(len(levels), dtype=torch.int32)
    return _level_radius_formula(levels, lvl).to(device)


def level_radius(levels, lvl):
    """Quantized radius of a level index (inverse of shift_level_index):
    exact integers, then the geometric region. The geometric radii come
    from exp, which CUDA's math library rounds otherwise than the CPU's in
    the last bit: every device reads the host's table."""
    tab = _level_radius_table(tuple(float(v) for v in levels), lvl.device)
    return tab[lvl.long()]


def sd_slice_origins(offs_i, guard: int, sd_h: int, sd_w: int, qh: int,
                     qw: int, divisor: int = 4):
    """Per (class, level) clamped SD-map origin (y0, x0) of direction i's
    strided fetch: the SD texel of full-res pixel 4q + c + d is
    (4/div) q + (c + d)//div + guard."""
    stride = 4 // divisor
    tab = np.zeros((16, len(offs_i[0]), 2), np.int64)
    for c in range(16):
        cy, cx = c // 4, c % 4
        for l, (dy, dx) in enumerate(offs_i[c]):
            tab[c, l] = (max(0, min((cy + dy) // divisor + guard,
                                    sd_h - 1 - (qh - 1) * stride)),
                         max(0, min((cx + dx) // divisor + guard,
                                    sd_w - 1 - (qw - 1) * stride)))
    return tab


def fetch_sd_direction(sd_map, lvl_planes, offs_i, guard: int, qh: int,
                       qw: int, divisor: int = 4):
    """Stochastic-depth fetch for direction i (divisor in {1, 2, 4}): a
    static strided slice of the guard-banded SD map [sd_h, sd_w, k] per
    (class, level). Returns [16, k, qh, qw] (any dtype)."""
    if divisor not in (1, 2, 4):
        raise ValueError(f"stochMapDivisor {divisor} not in (1, 2, 4)")
    stride = 4 // divisor
    sd_h, sd_w, k = sd_map.shape
    sd_pl = sd_map.permute(2, 0, 1)                      # [k, sd_h, sd_w]
    tab = sd_slice_origins(offs_i, guard, sd_h, sd_w, qh, qw, divisor)
    out = []
    for c in range(16):
        acc = torch.zeros((k, qh, qw), dtype=sd_map.dtype,
                          device=sd_map.device)
        for l in range(tab.shape[1]):
            y0, x0 = (int(v) for v in tab[c, l])
            sl = sd_pl[:, y0:y0 + (qh - 1) * stride + 1:stride,
                       x0:x0 + (qw - 1) * stride + 1:stride]
            acc = torch.where(lvl_planes[c] == l, sl, acc)
        out.append(acc)
    return torch.stack(out)


def tiled_jitter(qh: int, qw: int, enabled: bool = True, *, device):
    """The 4x4 SD-map sub-texel jitter tiled over quarter coordinates."""
    if not enabled:
        return torch.full((qh, qw, 2), 0.5, device=device)
    tab = JITTER_4X4.reshape(4, 4, 2)
    return torch.as_tensor(
        np.tile(tab, (-(-qh // 4), -(-qw // 4), 1))[:qh, :qw].copy(),
        device=device)
