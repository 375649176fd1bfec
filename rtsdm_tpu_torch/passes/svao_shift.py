"""SVAO phases in shift mode (counterpart of rtsdm_tpu/passes/svao_shift.py;
reference SVAORaster.ps.slang for phase 1, Common.slang calcAO2 for phase 2).

Every 2/3-vector is kept as separate planes, and after the per-pixel setup
everything runs in deinterleaved space: [16, qh, qw] planes in which the
ring's screen directions and the dither rotation are per-class constants.
The depth fetches of both phases go through K3 (ops/fetch_cuda.
fetch_all_directions) and the SD fetch of phase 2 through K4
(fetch_sd_packed) at stochMapDivisor 4 and K11 (fetch_sd_strided) at 1
and 2, with the ring tables of cfg's kernel (VAO or HBAO). Phase 2's
direction loop is K12 (ops/resolve_cuda.svao_resolve): one launch for the
whole ring on K4's planes, one a direction after each K11 fetch; its
plain version is svao_resolve_plain.
Both phases take the primary depth mode (SingleDepth or DualDepth, a
second layer `depth2`), phase 1 the secondary one (StochasticDepth, or
any other: no SD ray intervals), and cfg.dual_ao the bright/dark pair of
channels.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.profiler import profile_scope
from ..ops import ao as A
from ..ops import ao_shift as S
from ..ops.fetch_cuda import (fetch_all_directions, fetch_sd_packed,
                              fetch_sd_strided, offs_tuple, unpack_sd16)
from ..ops.resolve_cuda import svao_resolve
from ..utils.device import device_constant
from ..utils.math import true_div
from ..utils.sampling import AO_KERNEL_VAO, jitter_grid


def _cam_consts(cam, cfg):
    """imageScale (SVAO/Common.slang:142) and GetAORadiusInPixels collapsed
    to kpx * r / z (Common.slang:255-261)."""
    w, h = cfg.resolution
    sx = 0.5 * cam.frame_width / cam.focal_length
    sy = 0.5 * cam.frame_height / cam.focal_length
    kpx = 0.5 * (device_constant(float(w), sx.dtype, sx.device) / sx
                 + device_constant(float(h), sy.dtype, sy.device) / sy) * 0.5
    return sx, sy, kpx


def _pad_edge(a, hp: int, wp: int):
    """Edge-replicate pad [h, w(, c)] up to [hp, wp(, c)]."""
    h, w = a.shape[:2]
    if (hp, wp) == (h, w):
        return a
    chw = a[None] if a.ndim == 2 else a.permute(2, 0, 1)
    p = torch.nn.functional.pad(chw[None], (0, wp - w, 0, hp - h),
                                mode="replicate")[0]
    return p[0] if a.ndim == 2 else p.permute(1, 2, 0)


def _prep_planar(cam, cfg, depth, normal_v):
    """basic_init (Common.slang:271-324), planar."""
    h, w = depth.shape
    w_full, h_full = cfg.resolution
    hp, wp = h + (-h) % 4, w + (-w) % 4
    depth = _pad_edge(depth, hp, wp)
    normal_v = _pad_edge(normal_v, hp, wp)
    dev = depth.device
    sx, sy, kpx = _cam_consts(cam, cfg)
    ux = true_div(torch.arange(wp, dtype=torch.float32, device=dev) + 0.5,
                  w_full)[None, :].expand(hp, wp)
    uy = true_div(torch.arange(hp, dtype=torch.float32, device=dev) + 0.5,
                  h_full)[:, None].expand(hp, wp)

    radius_px = kpx * cfg.radius / torch.clamp(depth, min=1e-6)
    radius = torch.full_like(depth, cfg.radius)
    too_big = radius_px > cfg.ss_max_radius
    radius = torch.where(too_big, radius / radius_px * cfg.ss_max_radius,
                         radius)
    radius_px = torch.clamp(radius_px, max=cfg.ss_max_radius)
    valid = radius_px >= 0.5

    px = (2.0 * ux - 1.0) * sx * depth
    py = (1.0 - 2.0 * uy) * sy * depth
    pz = -depth
    pos_len = torch.sqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-12))

    nx, ny, nz = normal_v.unbind(-1)
    flip = (px * nx + py * ny + pz * nz) > 0.0
    nx, ny, nz = (torch.where(flip, -c, c) for c in (nx, ny, nz))

    rx, ry = A.dither_rotation_for(hp, wp, dev)
    # frame: normal = -pos/len; bitangent = norm(cross(normal, (rx, ry, 0)));
    # tangent = cross(bitangent, normal) (Common.slang:314-317)
    inv_l = 1.0 / pos_len
    ax, ay, az = -px * inv_l, -py * inv_l, -pz * inv_l
    bx = ay * 0.0 - az * ry
    by = az * rx - ax * 0.0
    bz = ax * ry - ay * rx
    bl = torch.sqrt(torch.clamp(bx * bx + by * by + bz * bz, min=1e-12))
    bx, by, bz = bx / bl, by / bl, bz / bl
    tx = by * az - bz * ay
    ty = bz * ax - bx * az
    tz = bx * ay - by * ax
    return dict(depth=depth, radius=radius, radius_px=radius_px, valid=valid,
                px=px, py=py, pz=pz, pos_len=pos_len, n=(nx, ny, nz),
                a=(ax, ay, az),
                no=(nx * tx + ny * ty + nz * tz, nx * bx + ny * by + nz * bz,
                    nx * ax + ny * ay + nz * az),
                sx=sx, sy=sy, hp=hp, wp=wp)


_BQ_KEYS = ("depth", "radius", "radius_px", "valid", "px", "py", "pz",
            "pos_len")


def _deint_b(b):
    """Deinterleave the per-pixel setup planes once; everything downstream
    is elementwise, so deint(f(x)) == f(deint(x))."""
    bq = {k: S.deinterleave(b[k]) for k in _BQ_KEYS}
    for k in ("n", "a", "no"):
        bq[k] = tuple(S.deinterleave(x) for x in b[k])
    bq["sx"], bq["sy"] = b["sx"], b["sy"]
    return bq


def _class_grids(qh: int, qw: int, device):
    """Full-res pixel coordinates of each class texel: (y, x) = (4*qy + cy,
    4*qx + cx)."""
    c = torch.arange(16, dtype=torch.float32, device=device)
    cyc = torch.div(c, 4, rounding_mode="floor").reshape(16, 1, 1)
    cxc = torch.remainder(c, 4).reshape(16, 1, 1)
    xg = 4.0 * torch.arange(qw, dtype=torch.float32, device=device) \
        .expand(16, qh, qw) + cxc
    yg = 4.0 * torch.arange(qh, dtype=torch.float32, device=device)[:, None] \
        .expand(16, qh, qw) + cyc
    return xg, yg


@functools.lru_cache(maxsize=64)
def _class_consts(alpha: float, device):
    """Per-class screen direction of ring direction alpha, [16, 1, 1], made
    on `device` once per (alpha, device) and shared."""
    with profile_scope("tables.svao"):
        thetas = S.class_angles()
        u = np.asarray([S.screen_dir(alpha, float(t)) for t in thetas],
                       np.float32)
        ux = torch.as_tensor(u[:, 0].reshape(16, 1, 1).copy(), device=device)
        uy = torch.as_tensor(u[:, 1].reshape(16, 1, 1).copy(), device=device)
        return ux, uy


def _visibility_vao(cfg, oz, s_start, s_end, pdf, radius):
    """calcVisibility (Common.slang:180-196)."""
    sphere = torch.clamp(s_start - torch.maximum(s_end, oz), min=0.0) / pdf
    halo = (torch.clamp((oz - (1.0 + cfg.thickness) * radius) / s_start,
                        0.0, 1.0) * (s_start - s_end) / pdf)
    return sphere + halo


def _sample_coeffs(bq, cx, cy, kernel: int):
    """Depth-affine coefficients of the view-space sample point v(z) =
    (cx z, cy z, -z): oz = (v - p) . a = z * oz_a + |p| (a = -p/|p|) and,
    for the HBAO kernel, |v - p|^2 = (z qa + qb) z + |p|^2 and
    n . (v - p) = z na - n . p."""
    ax, ay, az = bq["a"]
    co = dict(oz_a=cx * ax + cy * ay - az)
    if kernel != AO_KERNEL_VAO:
        nx, ny, nz = bq["n"]
        px, py, pz = bq["px"], bq["py"], bq["pz"]
        co.update(qa=cx * cx + cy * cy + 1.0,
                  qb=-2.0 * (cx * px + cy * py - pz),
                  na=nx * cx + ny * cy - nz,
                  np_=nx * px + ny * py + nz * pz)
    return co


def _hbao_affine(cfg, bq, co, z, pdf):
    """HBAOKernel (Common.slang:421-430) of the sample at depth z through
    the affine coefficients."""
    plen = bq["pos_len"]
    vv = torch.clamp((z * co["qa"] + co["qb"]) * z + plen * plen, min=1e-12)
    ndotv = (z * co["na"] - co["np_"]) / torch.sqrt(vv)
    angle = torch.clamp(ndotv - 0.1, 0.0, 1.0)
    dist = torch.clamp(1.0 - true_div(vv, cfg.radius * cfg.radius), 0.0,
                       1.0)
    return torch.clamp(angle * dist / pdf, 0.0, 1.0)


def _eval_depth_affine(cfg, bq, co, z, s_start, s_end, pdf):
    """(vis, oz) of the fetched depth plane z: UVToViewSpace at the sample
    uv is affine in z, oz = (v(z) - p) . (-p/|p|) = z * oz_a + |p|."""
    oz = z * co["oz_a"] + bq["pos_len"]
    if cfg.kernel == AO_KERNEL_VAO:
        return _visibility_vao(cfg, oz, s_start, s_end, pdf,
                               bq["radius"]), oz
    return _hbao_affine(cfg, bq, co, z, pdf), oz


def _sample_dir_q(cfg, bq, xg_q, yg_q, levels, r_frac: float, alpha: float,
                  fetched_q, fetched2_q=None):
    """One ring direction in deinterleaved space: quantized radius, sample
    position, sphere slab and the visibility of the fetched depth (and of
    the second layer's, min-combined with the first's, under DualDepth)."""
    w, h = cfg.resolution
    lvl = A.shift_level_index(levels, bq["radius_px"] * r_frac)
    r_eff = S.level_radius(levels, lvl)
    ux_c, uy_c = _class_consts(alpha, r_eff.device)
    off_x = torch.round(r_eff * ux_c)
    off_y = torch.round(r_eff * uy_c)

    r_disc = torch.clamp(r_eff / torch.clamp(bq["radius_px"], min=1e-4),
                         max=0.999) * bq["radius"]
    same_pix = (off_y == 0.0) & (off_x == 0.0)
    sxp = xg_q + off_x
    syp = yg_q + off_y
    in_screen = (sxp >= 0) & (sxp < w) & (syp >= 0) & (syp < h)
    uqx = true_div(torch.clamp(sxp, 0, w - 1) + 0.5, w)
    uqy = true_div(torch.clamp(syp, 0, h - 1) + 0.5, h)

    sphere_h = torch.sqrt(torch.clamp(bq["radius"] ** 2 - r_disc ** 2,
                                      min=1e-12))
    if cfg.kernel == AO_KERNEL_VAO:
        pdf = 2.0 * sphere_h
    else:
        pdf = torch.full_like(sphere_h, 0.9 * (1.0 - r_frac) ** 1.5)
    no_x, no_y, no_z = bq["no"]
    dxy_x = r_disc * math.sin(alpha)
    dxy_y = r_disc * math.cos(alpha)
    z_int = -(dxy_x * no_x + dxy_y * no_y) / A.make_nonzero(no_z, 1e-4)
    s_end = torch.clamp(z_int, min=-sphere_h, max=sphere_h)
    valid = (sphere_h - s_end) / (2.0 * sphere_h) > 0.1

    cx = (2.0 * uqx - 1.0) * bq["sx"]
    cy = (1.0 - 2.0 * uqy) * bq["sy"]
    co = _sample_coeffs(bq, cx, cy, cfg.kernel)
    vis, oz = _eval_depth_affine(cfg, bq, co, fetched_q, sphere_h, s_end,
                                 pdf)
    vis2 = oz2 = None
    if fetched2_q is not None:
        v2, o2 = _eval_depth_affine(cfg, bq, co, fetched2_q, sphere_h,
                                    s_end, pdf)
        vis_best = torch.minimum if cfg.kernel == AO_KERNEL_VAO \
            else torch.maximum
        vis2, oz2 = vis_best(vis, v2), torch.minimum(oz, o2)
    return dict(off_x=off_x, off_y=off_y, same_pix=same_pix,
                in_screen=in_screen, sphere_start=sphere_h, sphere_end=s_end,
                pdf=pdf, valid=valid, ss_radius=r_eff, vis=vis, oz=oz,
                vis2=vis2, oz2=oz2)


def _require_ray(cfg, bq, s, oz):
    """requireRay (Common.slang:455-461)."""
    if cfg.kernel == AO_KERNEL_VAO:
        cr = (1.0 + cfg.thickness) * bq["radius"] - s["sphere_start"]
        return ((oz > s["sphere_start"] + cr)
                & (s["ss_radius"] > cfg.ss_radius_cutoff))
    return ((oz > torch.maximum(s["sphere_start"], bq["radius"] * 0.1))
            & (s["ss_radius"] > cfg.ss_radius_cutoff))


def _ring(cfg):
    """(levels, offs, radii, pad) of cfg's ring of directions."""
    return _ring_tables(int(cfg.num_directions), int(cfg.kernel),
                        float(cfg.ss_max_radius))


@functools.lru_cache(maxsize=8)
def _ring_tables(num_directions: int, kernel: int, max_radius: float):
    """The ring's tables, built once per configuration and kept immutable
    (a read-only levels array, tuples): K3's and K4's wrappers find their
    device tables by these objects' identity (ops/fetch_cuda._tables)."""
    cfg = A.VAOConfig(num_directions=num_directions, kernel=kernel,
                      ss_max_radius=max_radius)
    levels, offs, radii = S.offset_tables(cfg, max_radius)
    levels = np.array(levels, np.float32)
    levels.setflags(write=False)
    return (levels, offs_tuple(offs), tuple(float(r) for r in radii),
            int(-(-float(levels[-1]) // 4)) + 1)


def _depth_planes(depth, hp: int, wp: int, pad: int):
    """A depth layer edge-padded to [hp, wp], deinterleaved and its planes
    padded for the shift fetch."""
    return S.pad_planes(S.deinterleave(_pad_edge(depth, hp, wp)), pad)


def svao_phase1_shift(cam, cfg, depth, normal_v, guard: int,
                      use_ray_interval: bool = True, *, depth2=None,
                      primary: str = "SingleDepth",
                      secondary: str = "StochasticDepth",
                      trace_out_of_screen: bool = False):
    """Phase 1 (SVAORaster.ps.slang): returns ao_raw [H,W] ([H,W,2] bright
    and dark under cfg.dual_ao), stencil [H,W] int32 (bit i = direction i
    needs the secondary depth), ray_min / ray_max [sd_h, sd_w] (the
    guard-banded SD grid; empty, FLT_MAX and 0, unless the secondary mode
    is StochasticDepth). Under DualDepth, depth2 is the second layer: both
    layers are fetched by one K3 call, and where the first layer's sample
    needs a ray the second's combined visibility is taken (min under VAO,
    max under HBAO). With the Raytraced secondary mode and
    trace_out_of_screen, off-screen samples always ask for a ray."""
    from .svao import (DEPTH_MODE_DUAL, DEPTH_MODE_RAYTRACED,
                       DEPTH_MODE_STOCHASTIC, _intervals_to_sd_grid)
    h, w = depth.shape
    w_full, h_full = cfg.resolution
    b = _prep_planar(cam, cfg, depth, normal_v)
    hp, wp = b["hp"], b["wp"]
    levels, offs, radii, pad = _ring(cfg)
    sets = [S.pad_planes(S.deinterleave(b["depth"]), pad)]
    dual = primary == DEPTH_MODE_DUAL
    if dual:
        sets.append(_depth_planes(depth2, hp, wp, pad))
    stochastic = secondary == DEPTH_MODE_STOCHASTIC
    vao = cfg.kernel == AO_KERNEL_VAO
    nd = cfg.num_directions
    qh, qw = hp // 4, wp // 4
    bq = _deint_b(b)
    dev = depth.device
    xg_q, yg_q = _class_grids(qh, qw, dev)
    interior = ((xg_q >= guard) & (xg_q < w_full - guard)
                & (yg_q >= guard) & (yg_q < h_full - guard))

    bright = torch.zeros((16, qh, qw), device=dev)
    dark = torch.zeros((16, qh, qw), device=dev)
    stencil = torch.zeros((16, qh, qw), dtype=torch.int32, device=dev)
    pix_rmin = torch.full((16, qh, qw), A.FLT_MAX, device=dev)
    pix_rmax = torch.zeros((16, qh, qw), device=dev)
    fetched = fetch_all_directions(sets, pad, bq["radius_px"], levels, offs,
                                   radii)
    for i in range(nd):
        alpha = (i / nd) * 2.0 * 3.141
        s = _sample_dir_q(cfg, bq, xg_q, yg_q, levels, float(radii[i]),
                          alpha, fetched[0][i],
                          fetched[1][i] if dual else None)
        vis, oz = s["vis"], s["oz"]
        if dual:
            need2 = _require_ray(cfg, bq, s, oz)
            vis = torch.where(need2, s["vis2"], vis)
            oz = torch.where(need2, s["oz2"], oz)
        same_contrib = ((s["sphere_start"] - s["sphere_end"]) / s["pdf"]
                        if vao else torch.zeros_like(vis))
        contrib = torch.where(s["same_pix"], same_contrib, vis)
        bright = bright + torch.where(s["valid"], contrib, 0.0)

        force_ray = torch.zeros_like(s["same_pix"])
        oz_int = oz
        if secondary == DEPTH_MODE_RAYTRACED and trace_out_of_screen:
            force_ray = force_ray | ~s["in_screen"]
        if cfg.sd_guard > 0:
            off = ~s["in_screen"]
            force_ray = force_ray | off
            oz_int = torch.where(off, A.FLT_MAX, oz)  # SVAORaster.ps.slang:75
        need = _require_ray(cfg, bq, s, oz) | force_ray
        need = need & s["valid"] & ~s["same_pix"] & bq["valid"] & interior
        stencil = stencil | torch.where(need, 1 << i, 0).to(torch.int32)

        if stochastic:
            if vao:
                oz_min = torch.minimum(oz_int, bq["radius"] + cfg.thickness
                                       * bq["radius"] + s["sphere_start"])
            else:
                oz_min = torch.minimum(oz_int, s["sphere_start"])
            rmin_v = torch.clamp(bq["pos_len"] - oz_min, min=0.0)
            rmax_v = torch.clamp(bq["pos_len"] - s["sphere_end"], min=0.0)
            if not use_ray_interval:
                rmin_v = torch.zeros_like(rmin_v)
                rmax_v = torch.ones_like(rmax_v)
            pix_rmin = torch.minimum(pix_rmin,
                                     torch.where(need, rmin_v, A.FLT_MAX))
            pix_rmax = torch.maximum(pix_rmax, torch.where(need, rmax_v, 0.0))
        elif cfg.dual_ao:
            dark = dark + torch.where(~need & s["valid"] & ~s["same_pix"],
                                      vis, 0.0)
        if cfg.dual_ao:
            # the same-pixel contribution lands on both channels
            # (SVAORaster.ps.slang:55-59)
            dark = dark + torch.where(s["same_pix"] & s["valid"],
                                      same_contrib, 0.0)

    def crop(a):
        return S.interleave(a, hp, wp)[:h, :w]

    bg = ~b["valid"][:h, :w]
    scale = (2.0 if vao else 1.0) / nd
    ao_raw = torch.where(bg, 1.0, crop(bright) * scale)
    if cfg.dual_ao:
        ao_raw = torch.stack(
            [ao_raw, torch.where(bg, 1.0, crop(dark) * scale)], -1)
    stencil = torch.where(bg, 0, crop(stencil))
    sd_w = cfg.low_resolution[0] + 2 * cfg.sd_guard
    sd_h = cfg.low_resolution[1] + 2 * cfg.sd_guard
    if stochastic:
        ray_min, ray_max = _intervals_to_sd_grid(
            cfg, b["radius_px"][:h, :w], crop(pix_rmin), crop(pix_rmax),
            sd_h, sd_w)
    else:
        ray_min = torch.full((sd_h, sd_w), A.FLT_MAX, device=dev)
        ray_max = torch.zeros((sd_h, sd_w), device=dev)
    return dict(ao_raw=ao_raw, stencil=stencil, ray_min=ray_min,
                ray_max=ray_max)


def _sd_eval_deint(cfg, bq, sd_p, s, jqx, jqy, xg_q, yg_q, divisor: int,
                   low_w: int, low_h: int, depth_range, near_z, k: int,
                   packed16: bool):
    """calcAO2's stochastic-depth branch (Common.slang:562-597) in
    deinterleaved space. sd_p: [16, k, qh, qw] fetched SD slots, or with
    packed16 the [16, ceil(k/2), qh, qw] int32 16-bit pairs of K4. Returns
    the visibility over the k layers, [16, qh, qw]: their min under the VAO
    kernel, their max under HBAO."""
    tex_x = torch.floor((xg_q + s["off_x"]) / float(divisor))
    tex_y = torch.floor((yg_q + s["off_y"]) / float(divisor))
    suv_x = true_div(tex_x + jqx, low_w)
    suv_y = true_div(tex_y + jqy, low_h)
    cxs = (2.0 * suv_x - 1.0) * bq["sx"]
    cys = (1.0 - 2.0 * suv_y) * bq["sy"]
    co = _sample_coeffs(bq, cxs, cys, cfg.kernel)
    vao = cfg.kernel == AO_KERNEL_VAO
    acc = None
    for kk in range(k):
        sd_val = unpack_sd16(sd_p, kk) if packed16 else sd_p[:, kk]
        lin = sd_val * depth_range + near_z
        if vao:
            v_k = _visibility_vao(cfg, lin * co["oz_a"] + bq["pos_len"],
                                  s["sphere_start"], s["sphere_end"],
                                  s["pdf"], bq["radius"])
            acc = v_k if acc is None else torch.minimum(acc, v_k)
        else:
            v_k = _hbao_affine(cfg, bq, co, lin, s["pdf"])
            acc = v_k if acc is None else torch.maximum(acc, v_k)
    return acc


def svao_resolve_plain(cfg, bq, levels, radii, fetched, sd, stencil_q,
                       depth_range, near_z, k: int, divisor: int,
                       sd_jitter: bool, delta_q=None, d=None):
    """Plain PyTorch version of K12 (ops/resolve_cuda.svao_resolve), with
    its arguments: calcAO2's direction loop in deinterleaved space over
    ring direction d (every direction when d is None), each stenciled
    direction's vis - old_vis added to delta_q (zeros when None) in
    direction order. sd: K4's packed [nd, 16, ceil(k/2), qh, qw] int32 of
    every direction, or direction d's [16, k, qh, qw] float slots."""
    qh, qw = stencil_q.shape[1:]
    dev = stencil_q.device
    xg_q, yg_q = _class_grids(qh, qw, dev)
    jit_q = jitter_grid(qh, qw, sd_jitter, device=dev)
    jqx, jqy = jit_q[..., 0], jit_q[..., 1]
    low_w, low_h = cfg.low_resolution
    nd = cfg.num_directions
    vao = cfg.kernel == AO_KERNEL_VAO
    packed = sd.dtype == torch.int32
    if delta_q is None:
        delta_q = torch.zeros((16, qh, qw), device=dev)
    for i in (range(nd) if d is None else (d,)):
        bit = ((stencil_q >> i) & 1).to(torch.bool)
        alpha = (i / nd) * 2.0 * 3.141
        s = _sample_dir_q(cfg, bq, xg_q, yg_q, levels, float(radii[i]),
                          alpha, fetched[i])
        old_vis = s["vis"]
        vis = torch.where(s["in_screen"], s["vis"], 1.0 if vao else 0.0)
        vis_sd = _sd_eval_deint(cfg, bq, sd if d is not None else sd[i], s,
                                jqx, jqy, xg_q, yg_q, divisor, low_w, low_h,
                                depth_range, near_z, k, packed)
        vis = torch.minimum(vis, vis_sd) if vao \
            else torch.maximum(vis, vis_sd)
        delta_q = delta_q + torch.where(bit, vis - old_vis, 0.0)
    return delta_q


def svao_phase2_shift(cam, cfg, depth, normal_v, stencil, sd_map,
                      sd_jitter: bool = True, divisor: int = 4, *,
                      depth2=None, primary: str = "SingleDepth"):
    """Stochastic-depth resolve (calcAO2, Common.slang:523-663): the
    additive correction to phase 1's raw AO on stenciled directions,
    [H, W] ([H, W, 2] under cfg.dual_ao, the dark channel's 0). Under
    DualDepth the primary visibility is read from depth2's layer.
    stochMapDivisor must be 1, 2 or 4."""
    from .svao import DEPTH_MODE_DUAL
    h, w = depth.shape
    b = _prep_planar(cam, cfg, depth, normal_v)
    hp, wp = b["hp"], b["wp"]
    levels, offs, radii, pad = _ring(cfg)
    layer_pp = (_depth_planes(depth2, hp, wp, pad)
                if primary == DEPTH_MODE_DUAL
                else S.pad_planes(S.deinterleave(b["depth"]), pad))
    nd = cfg.num_directions
    qh, qw = hp // 4, wp // 4
    g = cfg.sd_guard
    depth_range = cam.far_z - cam.near_z
    stencil_q = S.deinterleave(torch.nn.functional.pad(
        stencil, (0, wp - w, 0, hp - h)))
    bq = _deint_b(b)
    k_sd = sd_map.shape[-1]

    rq = bq["radius_px"]
    fetched = fetch_all_directions([layer_pp], pad, rq, levels, offs,
                                   radii)[0]
    sd_pre = (fetch_sd_packed(sd_map, g, rq, levels, offs, radii, pad)
              if divisor == 4 else None)
    resolve = (cfg, bq, levels, radii, fetched)
    setting = (stencil_q, depth_range, cam.near_z, k_sd, divisor, sd_jitter)
    if sd_pre is not None:
        delta_q = svao_resolve(*resolve, sd_pre, *setting)
    else:
        # one direction's fetch alive at a time, summed in direction order
        delta_q = None
        for i in range(nd):
            sd_i = fetch_sd_strided(sd_map, g, rq, levels, offs, radii, i,
                                    divisor)
            delta_q = svao_resolve(*resolve, sd_i, *setting, delta_q, i)
    scale = (2.0 if cfg.kernel == AO_KERNEL_VAO else 1.0) / nd
    delta = S.interleave(delta_q, hp, wp)[:h, :w] * scale
    if cfg.dual_ao:
        delta = torch.stack([delta, torch.zeros_like(delta)], -1)
    return delta
