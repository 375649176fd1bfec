"""All-direction shifted fetches of the SVAO phases: the wrappers of
csrc/fetch.cu (K3 direction fetch, K4 packed SD fetch), their plain PyTorch
versions, and the 16-bit SD unpack (counterpart of
rtsdm_tpu/ops/fetch_pallas.py, fetch_all_directions and fetch_sd_packed).

Both kernels read a static per-configuration table: for every direction,
class and radius level the source (class and) offset of the shifted read.
The tables are built from ao_shift.offset_tables once per configuration and
kept on the device (a small bounded cache).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._build import launch, ptr, stream_of
from ..utils.math import true_div
from . import ao as A
from . import ao_shift as S


def _offs_key(offs):
    return tuple(tuple(tuple((int(dy), int(dx)) for (dy, dx) in cl)
                       for cl in d) for d in offs)


def direction_table(offs, pad: int) -> np.ndarray:
    """[nd, 16, L, 3] int32: (source class c2, padded-plane y, x) of the
    read for direction d, class c, level l (ao_shift.fetch_direction's
    mapping)."""
    tab = np.zeros((len(offs), 16, len(offs[0][0]), 3), np.int32)
    for d, per_c in enumerate(offs):
        for c in range(16):
            cy, cx = c // 4, c % 4
            for l, (dy, dx) in enumerate(per_c[c]):
                tab[d, c, l] = (((cy + dy) % 4) * 4 + (cx + dx) % 4,
                                pad + max(-pad, min(pad, (cy + dy) // 4)),
                                pad + max(-pad, min(pad, (cx + dx) // 4)))
    return tab


def sd_table(offs, guard: int, pad: int, sd_h: int, sd_w: int, qh: int,
             qw: int):
    """([nd, L, 16, 2] int32 clamped SD-map origins (y0, x0), ok). ok is
    False when a clamp at the map edge moves an origin more than `pad` from
    its unclamped place — the reference's condition for leaving the packed
    fetch (fetch_pallas.py:_sd_tables); the caller then uses
    ao_shift.fetch_sd_direction."""
    tab = np.stack([S.sd_slice_origins(o, guard, sd_h, sd_w, qh, qw)
                    for o in offs]).transpose(0, 2, 1, 3)   # [nd, L, 16, 2]
    local = tab - guard + pad
    ok = bool(((local >= 0) & (local <= 2 * pad)).all())
    return np.ascontiguousarray(tab, np.int32), ok


@functools.lru_cache(maxsize=8)
def _host_table(kind, key):
    """(table, ok) of one configuration (see direction_table, sd_table)."""
    _, offs, _, extra = key
    if kind == "dir":
        return direction_table(offs, *extra), True
    return sd_table(offs, *extra)


@functools.lru_cache(maxsize=8)
def _device_tables(kind, key, device):
    """Per-configuration lookup tables on `device` (immutable, cached)."""
    levels, _, radii, _ = key
    bounds = A.level_bounds(np.asarray(levels, np.float32))
    return (torch.as_tensor(bounds, device=device),
            torch.as_tensor(np.asarray(radii, np.float32), device=device),
            torch.as_tensor(_host_table(kind, key)[0], device=device))


def _key(levels, offs, radii, extra):
    return (tuple(float(x) for x in levels), _offs_key(offs),
            tuple(float(r) for r in radii), tuple(extra))


def fetch_all_directions(padded_sets, pad: int, radius_px_q, levels, offs,
                         radii):
    """K3. padded_sets: list of [16, qh+2p, qw+2p] (ao_shift.pad_planes);
    radius_px_q [16, qh, qw]; levels/offs/radii from
    ao_shift.offset_tables. Returns a list over sets of [nd, 16, qh, qw];
    entry [d] equals fetch_direction(set, pad, shift_level_index(levels,
    radius * radii[d]), offs[d], qh, qw)."""
    qh, qw = radius_px_q.shape[1:]
    planes = torch.stack(list(padded_sets)).contiguous()
    radius = radius_px_q.contiguous()
    if planes.dtype != torch.float32 or radius.dtype != torch.float32:
        raise TypeError("fetch_all_directions: float32 planes and radius")
    n_src, _, ph, pw = planes.shape
    if (ph, pw) != (qh + 2 * pad, qw + 2 * pad):
        raise ValueError("fetch_all_directions: planes not padded by pad")
    if planes.is_cuda:
        bounds, radii_t, tab = _device_tables(
            "dir", _key(levels, offs, radii, (pad,)), planes.device)
        nd = len(offs)
        out = torch.empty((n_src, nd, 16, qh, qw), dtype=torch.float32,
                          device=planes.device)
        launch("rtsdm_fetch_directions", ptr(planes), ptr(radius),
               ptr(bounds), ptr(radii_t), ptr(tab), n_src, nd, len(levels),
               qh, qw, ph, pw, ptr(out), stream_of(planes))
        return list(out)
    if planes.device.type != "cpu":
        raise RuntimeError(f"fetch_all_directions: unsupported device "
                           f"{planes.device}")
    return fetch_all_directions_plain(planes, pad, radius, levels, offs,
                                      radii)


def fetch_all_directions_plain(planes, pad, radius_px_q, levels, offs,
                               radii):
    """Plain PyTorch version of K3: the per-direction select chain."""
    qh, qw = radius_px_q.shape[1:]
    lvls = [A.shift_level_index(levels, radius_px_q * float(r))
            for r in radii]
    return [torch.stack([S.fetch_direction(p, pad, lv, o, qh, qw)
                         for lv, o in zip(lvls, offs)]) for p in planes]


def pack_sd16(sd_map):
    """[sd_h, sd_w, k] normalized depths -> [ceil(k/2), sd_h, sd_w] int32:
    round(depth * 65535) of layer 2j in bits 0-15 and of layer 2j+1 in bits
    16-31 of plane j."""
    k = sd_map.shape[-1]
    d16 = torch.clamp(torch.round(sd_map.permute(2, 0, 1) * 65535.0),
                      0.0, 65535.0).to(torch.int64)
    if k % 2:
        d16 = torch.cat([d16, torch.zeros_like(d16[:1])])
    pk = d16[0::2] | (d16[1::2] << 16)
    return torch.where(pk >= 2**31, pk - 2**32, pk).to(torch.int32) \
        .contiguous()


def fetch_sd_packed(sd_map, guard: int, radius_px_q, levels, offs, radii,
                    pad: int):
    """K4 (divisor 4 only). sd_map [sd_h, sd_w, k] guard-banded normalized
    depths. Returns 16-bit-pair packed planes [nd, 16, ceil(k/2), qh, qw]
    int32 (see unpack_sd16), or None when the slice tables do not fit the
    halo of `pad` (tiny SD maps; the caller uses fetch_sd_direction)."""
    qh, qw = radius_px_q.shape[1:]
    sd_pl = pack_sd16(sd_map)
    kp, sd_h, sd_w = sd_pl.shape
    key = _key(levels, offs, radii, (guard, pad, sd_h, sd_w, qh, qw))
    if not _host_table("sd", key)[1]:
        return None
    radius = radius_px_q.contiguous()
    if sd_pl.is_cuda:
        bounds, radii_t, tab = _device_tables("sd", key, sd_pl.device)
        nd = len(offs)
        out = torch.empty((nd, 16, kp, qh, qw), dtype=torch.int32,
                          device=sd_pl.device)
        launch("rtsdm_fetch_sd_packed", ptr(sd_pl), ptr(radius), ptr(bounds),
               ptr(radii_t), ptr(tab), kp, nd, len(levels), qh, qw, sd_h,
               sd_w, ptr(out), stream_of(sd_pl))
        return out
    if sd_pl.device.type != "cpu":
        raise RuntimeError(f"fetch_sd_packed: unsupported device "
                           f"{sd_pl.device}")
    return fetch_sd_packed_plain(sd_pl, guard, radius, levels, offs, radii)


def fetch_sd_packed_plain(sd_pl, guard, radius_px_q, levels, offs, radii):
    """Plain PyTorch version of K4: the per-direction strided select on the
    packed planes."""
    qh, qw = radius_px_q.shape[1:]
    sd_hwk = sd_pl.permute(1, 2, 0)
    return torch.stack([
        S.fetch_sd_direction(sd_hwk, A.shift_level_index(
            levels, radius_px_q * float(r)), o, guard, qh, qw, 4)
        for r, o in zip(radii, offs)])


def unpack_sd16(packed, kk: int):
    """Layer kk of packed SD planes [..., kp, h, w] -> [..., h, w] float in
    [0, 1]: the 16-bit field (logical shift for the high half) over 65535,
    as a true float32 division (bit-equal to the grid value the ray tier
    stored)."""
    p = packed[..., kk // 2, :, :]
    v = (p & 0xFFFF) if kk % 2 == 0 else ((p >> 16) & 0xFFFF)
    return true_div(v.to(torch.float32), 65535.0)
