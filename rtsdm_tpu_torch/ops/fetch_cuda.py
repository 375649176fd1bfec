"""Shifted fetches of deinterleaved planes: the wrappers of csrc/fetch.cu
(K3 SVAO direction fetch, K4 packed SD fetch, K6 HBAO same-class taps),
their plain PyTorch versions, and the 16-bit SD unpack (counterpart of
rtsdm_tpu/ops/fetch_pallas.py: fetch_all_directions, fetch_sd_packed,
fetch_taps_same_class).

Every kernel reads a static per-configuration table: for every direction,
class and radius level the source (class and) offset of the shifted read.
The tables are built once per configuration (K3/K4 from
ao_shift.offset_tables, K6 from the HBAO ring's offsets) and kept on the
device (a small bounded cache). K3 and K4 find theirs by the identity of
the ring's tables, which the SVAO passes keep per configuration as
immutable tuples (passes/svao_shift._ring): a call neither walks nor
hashes them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._build import launch, ptr, stream_of
from ..core.profiler import profile_scope
from ..utils.math import true_div
from . import ao as A
from . import ao_shift as S


def offs_tuple(offs):
    """Offset tables offs[d][c][l] = (dy, dx) as nested tuples of ints."""
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


def same_class_table(offs, pad: int) -> np.ndarray:
    """[nd, 16, L, 2] int32: padded-plane (y, x) of the read for direction
    d, class c, level l from offs[d][c][l] = (dy, dx) in quarter texels,
    each clamped to +-pad (passes/hbao._fetch_slices's mapping)."""
    tab = np.zeros((len(offs), 16, len(offs[0][0]), 2), np.int32)
    for d, per_c in enumerate(offs):
        for c in range(16):
            for l, (dy, dx) in enumerate(per_c[c]):
                tab[d, c, l] = (pad + max(-pad, min(pad, int(dy))),
                                pad + max(-pad, min(pad, int(dx))))
    return tab


@functools.lru_cache(maxsize=8)
def _same_class_device_table(offs_key, pad: int, device):
    return torch.as_tensor(same_class_table(offs_key, pad), device=device)


# K3's and K4's tables by the identity of (levels, offs, radii); each entry
# holds those objects, so their ids are not reused while it lives
_TABLES: dict = {}
_TABLES_MAX = 16
MAX_BOUNDS = 63    # csrc/fetch.cu: K3's and K4's level search and shared
MAX_DIRS = 64      # memory hold their bounds and radii
TAPS_TABLE_BYTES = 48 * 1024   # K6's shared table slice tab[:, c]


def _build_tables(kind, levels, offs, radii, extra, device):
    """(bounds, radii, table) on `device` and whether the table fits (K4's
    halo condition; always True for K3)."""
    bounds = A.level_bounds(np.asarray(levels, np.float32))
    # the kernels' level search and shared memory
    searchable = (len(bounds) <= MAX_BOUNDS and len(offs) <= MAX_DIRS
                  and not bool((np.diff(bounds) < 0).any()))
    if kind == "dir":
        if not searchable:
            raise ValueError("fetch_all_directions: at most 63 ascending "
                             "level bounds and 64 directions")
        tab, ok = direction_table(offs, *extra), True
    else:
        tab, ok = sd_table(offs, *extra)
        if ok and not searchable and torch.device(device).type == "cuda":
            raise ValueError("fetch_sd_packed: at most 63 ascending level "
                             "bounds and 64 directions")
    return (torch.as_tensor(bounds, device=device),
            torch.as_tensor(np.asarray(radii, np.float32), device=device),
            torch.as_tensor(tab, device=device), ok)


def _tables(kind, levels, offs, radii, extra, device):
    """_build_tables of one configuration, cached while levels, offs and
    radii are the immutable objects svao_shift._ring keeps (a read-only
    array and tuples); other arguments are built anew on every call."""
    frozen = (isinstance(offs, tuple) and isinstance(radii, tuple)
              and isinstance(levels, np.ndarray)
              and not levels.flags.writeable)
    if not frozen:
        return _build_tables(kind, levels, offs, radii, extra, device)
    key = (kind, id(levels), id(offs), id(radii), extra, device)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not levels or hit[1] is not offs \
            or hit[2] is not radii:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.clear()
        hit = (levels, offs, radii,
               _build_tables(kind, levels, offs, radii, extra, device))
        _TABLES[key] = hit
    return hit[3]


def fetch_all_directions(padded_sets, pad: int, radius_px_q, levels, offs,
                         radii):
    """K3. padded_sets: list of [16, qh+2p, qw+2p] (ao_shift.pad_planes);
    radius_px_q [16, qh, qw]; levels/offs/radii from
    ao_shift.offset_tables. Returns a list over sets of [nd, 16, qh, qw];
    entry [d] equals fetch_direction(set, pad, shift_level_index(levels,
    radius * radii[d]), offs[d], qh, qw)."""
    with profile_scope("kernel.fetch_all_directions"):
        qh, qw = radius_px_q.shape[1:]
        sets = list(padded_sets)
        # one set (SVAO's phases) is read in place, not stacked
        planes = (sets[0][None] if len(sets) == 1 else torch.stack(sets)) \
            .contiguous()
        radius = radius_px_q.contiguous()
        if planes.dtype != torch.float32 or radius.dtype != torch.float32:
            raise TypeError("fetch_all_directions: float32 planes and radius")
        n_src, _, ph, pw = planes.shape
        if (ph, pw) != (qh + 2 * pad, qw + 2 * pad):
            raise ValueError("fetch_all_directions: planes not padded by pad")
        if planes.is_cuda:
            bounds, radii_t, tab, _ = _tables("dir", levels, offs, radii,
                                              (pad,), planes.device)
            nd = len(offs)
            out = torch.empty((n_src, nd, 16, qh, qw), dtype=torch.float32,
                              device=planes.device)
            if max(planes.numel(), out.numel()) >= 2**31:
                raise ValueError("fetch_all_directions: more than 2^31 values")
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


def _same_class_table_on(offs, pad: int, device):
    """same_class_table of offs on `device`, cached. A tuple
    (passes/hbao.shift_tables) is its own cache key: converting it would
    cost a millisecond of host time per call."""
    key = offs if isinstance(offs, tuple) else offs_tuple(offs)
    return _same_class_device_table(key, pad, device)


def _check_taps_inputs(planes, lvl_taps, pad: int):
    if planes.dtype != torch.float32 or lvl_taps.dtype != torch.int32:
        raise TypeError("fetch_taps_same_class: float32 planes, int32 "
                        "levels")
    if planes.ndim != 4 or planes.shape[1] != 16 or lvl_taps.ndim != 4 \
            or lvl_taps.shape[1] != 16 \
            or planes.shape[2:] != (lvl_taps.shape[2] + 2 * pad,
                                    lvl_taps.shape[3] + 2 * pad) \
            or lvl_taps.device != planes.device:
        raise ValueError("fetch_taps_same_class: planes [n_src, 16, "
                         "qh+2p, qw+2p] padded by pad, levels [taps, 16, "
                         "qh, qw] on the same device")


def fetch_taps_same_class(planes, lvl_taps, pad: int, offs):
    """K6: nd * taps same-class taps from each plane set. planes [n_src,
    16, qh+2p, qw+2p] (ao_shift.pad_planes of the stacked sets); lvl_taps
    [taps, 16, qh, qw] int32 per-step level planes (shared by every
    direction); offs [nd][16][L] static (dy, dx) per level, quarter
    texels. Returns [n_src, nd * taps, 16, qh, qw]: entry [s, d * taps + k]
    reads class c's own plane at offs[d][c][lvl_taps[k, c, q]] (0 where the
    level is out of range)."""
    with profile_scope("kernel.fetch_taps_same_class"):
        _check_taps_inputs(planes, lvl_taps, pad)
        if planes.is_cuda:
            planes, lvl = planes.contiguous(), lvl_taps.contiguous()
            tab = _same_class_table_on(offs, pad, planes.device)
            n_src, _, ph, pw = planes.shape
            taps, _, qh, qw = lvl.shape
            nd, _, n_levels, _ = tab.shape
            if max(planes.numel(), lvl.numel(), n_src * nd * taps * 16 * qh
                   * qw) >= 2**31:
                raise ValueError("fetch_taps_same_class: more than 2^31 "
                                 "values")
            if nd * n_levels * 2 * 4 > TAPS_TABLE_BYTES:
                raise ValueError("fetch_taps_same_class: a class's table "
                                 f"slice exceeds {TAPS_TABLE_BYTES} bytes")
            out = torch.empty((n_src, nd * taps, 16, qh, qw),
                              dtype=torch.float32, device=planes.device)
            launch("rtsdm_fetch_taps_same_class", ptr(planes), ptr(lvl),
                   ptr(tab), n_src, nd, taps, n_levels, qh, qw, ph, pw,
                   ptr(out), stream_of(planes))
            return out
        if planes.device.type != "cpu":
            raise RuntimeError(f"fetch_taps_same_class: unsupported device "
                               f"{planes.device}")
        return fetch_taps_same_class_plain(planes, lvl_taps, pad, offs)


def fetch_taps_same_class_plain(planes, lvl_taps, pad: int, offs):
    """Plain PyTorch version of K6, with its arguments: the table lookup
    (same_class_table) and the gather."""
    _check_taps_inputs(planes, lvl_taps, pad)
    tab = _same_class_table_on(offs, pad, planes.device)
    taps, _, qh, qw = lvl_taps.shape
    n_levels = tab.shape[2]
    dev = planes.device
    ok = (lvl_taps >= 0) & (lvl_taps < n_levels)
    lvl = lvl_taps.clamp(0, n_levels - 1).long()
    c = torch.arange(16, device=dev)[None, :, None, None]
    qy = torch.arange(qh, device=dev)[:, None]
    qx = torch.arange(qw, device=dev)
    out = []
    for tab_d in tab.long():
        e = tab_d[c, lvl]                          # [taps, 16, qh, qw, 2]
        v = planes[:, c, e[..., 0] + qy, e[..., 1] + qx]
        out.append(torch.where(ok, v, 0.0))
    return torch.cat(out, 1)


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
    """K4 (divisor 4 only). sd_map [sd_h, sd_w, k] float32 guard-banded
    normalized depths. Returns 16-bit-pair packed planes [nd, 16,
    ceil(k/2), qh, qw] int32 (see unpack_sd16), or None when the slice
    tables do not fit the halo of `pad` (tiny SD maps; the caller uses
    fetch_sd_direction). On the card the kernel packs the depths itself;
    the contract it is held to is fetch_sd_packed_plain(pack_sd16(sd_map),
    ...)."""
    with profile_scope("kernel.fetch_sd_packed"):
        qh, qw = radius_px_q.shape[1:]
        sd_h, sd_w, k = sd_map.shape
        bounds, radii_t, tab, ok = _tables(
            "sd", levels, offs, radii, (guard, pad, sd_h, sd_w, qh, qw),
            sd_map.device)
        if not ok:
            return None
        radius = radius_px_q.contiguous()
        if sd_map.is_cuda:
            sd = sd_map.contiguous()
            if sd.dtype != torch.float32 or radius.dtype != torch.float32:
                raise TypeError("fetch_sd_packed: float32 SD map and radius")
            nd, n_levels = len(offs), len(levels)
            out = torch.empty((nd, 16, (k + 1) // 2, qh, qw),
                              dtype=torch.int32, device=sd.device)
            if max(sd.numel(), out.numel()) >= 2**31:
                raise ValueError("fetch_sd_packed: more than 2^31 values")
            launch("rtsdm_fetch_sd_packed", ptr(sd), ptr(radius), ptr(bounds),
                   ptr(radii_t), ptr(tab), k, nd, n_levels, qh, qw, sd_w,
                   ptr(out), stream_of(sd))
            return out
        if sd_map.device.type != "cpu":
            raise RuntimeError(f"fetch_sd_packed: unsupported device "
                               f"{sd_map.device}")
        return fetch_sd_packed_plain(pack_sd16(sd_map), guard, radius, levels,
                                     offs, radii)


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
