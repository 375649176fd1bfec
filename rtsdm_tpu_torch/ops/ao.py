"""SVAO math core (counterpart of rtsdm_tpu/ops/ao.py): the static config,
the quantized shift-radius levels, the helpers the shift-mode SVAO phases
call, and the per-pixel gather forms of BasicAOData and SampleAOData that
the gather sampling mode and the Raytraced secondary mode use (reference
SVAO/Common.slang)."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.math import cross, dot3, true_div
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

    @property
    def inv_resolution(self):
        return (1.0 / self.resolution[0], 1.0 / self.resolution[1])

    def radii(self):
        return sample_radius_table(self.num_directions, self.kernel)


def const_radius(cfg, radius, sphere_start):
    """CONST_RADIUS (Common.slang:37)."""
    return (1.0 + cfg.thickness) * radius - sphere_start


def make_nonzero(v, eps):
    a = torch.clamp(torch.abs(v), min=eps)
    return torch.where(v >= 0, a, -a)


def calc_halo_visibility(cfg, object_z, sphere_start, sphere_end, pdf,
                         radius):
    """Common.slang:180-184."""
    return (torch.clamp((object_z - (1.0 + cfg.thickness) * radius)
                        / sphere_start, 0.0, 1.0)
            * (sphere_start - sphere_end) / pdf)


def calc_sphere_visibility(object_z, sphere_start, sphere_end, pdf):
    """Common.slang:186-190."""
    return torch.clamp(sphere_start - torch.maximum(sphere_end, object_z),
                       min=0.0) / pdf


def calc_visibility(cfg, object_z, sphere_start, sphere_end, pdf, radius):
    return (calc_sphere_visibility(object_z, sphere_start, sphere_end, pdf)
            + calc_halo_visibility(cfg, object_z, sphere_start, sphere_end,
                                   pdf, radius))


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _norm3(v):
    return torch.sqrt(dot3(v, v))


def get_snapped_uv(uv, resolution):
    """Pixel-centre snap (Common.slang:116-120)."""
    res = _f32(resolution, uv.device)
    return (torch.floor(uv * res) + 0.5) / res


def uv_to_sd_pixel(cfg, uv):
    """Screen uv -> SD-map texel [..., 2] int64, guard-band shifted
    (Common.slang:164-168)."""
    low = _f32(cfg.low_resolution, uv.device)
    p = torch.floor(uv * low).to(torch.int64) + cfg.sd_guard
    hi = torch.tensor([cfg.low_resolution[0] + 2 * cfg.sd_guard - 1,
                       cfg.low_resolution[1] + 2 * cfg.sd_guard - 1],
                      device=uv.device)
    return torch.minimum(torch.clamp(p, min=0), hi)


def sample_depth_at(depth, uv):
    """Point sample a [H, W] texture at (pixel-snapped) uv."""
    h, w = depth.shape
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return depth[y, x]


def basic_init(cam, cfg, uv, depth_lin, normal_v, noise_rot):
    """BasicAOData (Common.slang:271-331), per pixel. noise_rot: [H, W] in
    [0, 1) (the dither texture). Returns a dict; 'valid' False means
    background or a sub-pixel radius (AO 1)."""
    res = _f32(cfg.resolution, uv.device)
    radius_uv = cam.view_space_radius_to_uv_radius(depth_lin, cfg.radius)
    radius_px = 0.5 * (radius_uv[..., 0] * res[0]
                       + radius_uv[..., 1] * res[1])
    radius = torch.full_like(depth_lin, cfg.radius)
    # clamp the screen-space radius (Common.slang:291-297)
    too_big = radius_px > cfg.ss_max_radius
    radius = torch.where(too_big, radius / radius_px * cfg.ss_max_radius,
                         radius)
    radius_px = torch.clamp(radius_px, max=cfg.ss_max_radius)
    valid = radius_px >= 0.5

    pos_v = cam.uv_to_view_space(uv, depth_lin)
    pos_len = torch.clamp(_norm3(pos_v), min=1e-8)
    n_v = torch.where((dot3(pos_v, normal_v) > 0.0)[..., None], -normal_v,
                      normal_v)
    rot = noise_rot * 2.0 * 3.141
    rand_dir = torch.stack([torch.sin(rot), torch.cos(rot),
                            torch.zeros_like(rot)], -1)
    normal = -pos_v / pos_len[..., None]
    bitangent = cross(normal, rand_dir)
    bitangent = bitangent / torch.clamp(_norm3(bitangent), min=1e-8)[..., None]
    tangent = cross(bitangent, normal)
    normal_o = torch.stack([dot3(n_v, tangent), dot3(n_v, bitangent),
                            dot3(n_v, normal)], -1)
    return dict(pos_v=pos_v, pos_len=pos_len, normal=normal,
                tangent=tangent, bitangent=bitangent, normal_o=normal_o,
                normal_v=n_v, radius=radius, radius_px=radius_px,
                valid=valid)


def dir_params(cfg, device):
    """Per ring direction: (alpha = i / N * 2 pi with the reference's 3.141,
    normalized radius, stencil bit), the first two float32 0-d tensors
    (Common.slang:356-358)."""
    nd = cfg.num_directions
    alphas = (np.arange(nd, dtype=np.float32) / nd) * 2.0 * 3.141
    radii = np.asarray(cfg.radii(), np.float32)
    return [(torch.tensor(alphas[i], device=device),
             torch.tensor(radii[i], device=device), 1 << i)
            for i in range(nd)]


def sample_init(cam, cfg, basic, alpha, r_i, uv):
    """SampleAOData's per-direction setup (Common.slang:334-420); 'valid'
    False = below the hemisphere (skipped)."""
    radius = r_i * basic["radius"]
    dxy = torch.stack([radius * torch.sin(alpha), radius * torch.cos(alpha)],
                      -1)
    sphere_height = torch.sqrt(torch.clamp(basic["radius"] ** 2
                                           - radius ** 2, min=1e-12))
    if cfg.kernel == AO_KERNEL_VAO:
        pdf = 2.0 * sphere_height
    else:
        pdf = (0.9 * (1.0 - r_i) ** 1.5).expand(sphere_height.shape)
    sphere_start = sphere_height
    n_o = basic["normal_o"]
    z_int = -(dxy[..., 0] * n_o[..., 0] + dxy[..., 1] * n_o[..., 1]) \
        / make_nonzero(n_o[..., 2], 1e-4)
    sphere_end = torch.clamp(z_int, min=-sphere_height, max=sphere_height)
    valid = (sphere_start - sphere_end) / (2.0 * sphere_height) > 0.1

    sample_pos_v = (basic["pos_v"] + basic["tangent"] * dxy[..., 0:1]
                    + basic["bitangent"] * dxy[..., 1:2])
    sample_len = _norm3(sample_pos_v)
    sample_uv = cam.view_space_to_uv(sample_pos_v)
    res = _f32(cfg.resolution, uv.device)
    d = (uv - sample_uv) * res
    ss_radius = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    screen_uv = torch.clamp(sample_uv, 0.0, 1.0)
    in_screen = (sample_uv == screen_uv).all(-1)
    raster_uv = get_snapped_uv(screen_uv, cfg.resolution)
    return dict(sphere_start=sphere_start, sphere_end=sphere_end, pdf=pdf,
                valid=valid, sample_uv=sample_uv, raster_uv=raster_uv,
                in_screen=in_screen, ss_radius=ss_radius,
                sample_len=torch.clamp(sample_len, min=1e-8), radius=radius)


def hbao_kernel(cfg, basic, sample_pos_v):
    """HBAOKernel (Common.slang:421-430)."""
    v = sample_pos_v - basic["pos_v"]
    vv = dot3(v, v)
    ndotv = dot3(basic["normal_v"], v) / torch.sqrt(torch.clamp(vv,
                                                                min=1e-12))
    angle = torch.clamp(ndotv - 0.1, 0.0, 1.0)
    dist = torch.clamp(1.0 - true_div(vv, cfg.radius * cfg.radius), 0.0,
                       1.0)
    return angle * dist


def add_sample(cfg, basic, s, sample_pos_v, vis, oz, init: bool):
    """SampleAOData::addSample (Common.slang:463-483). Returns (vis, oz)."""
    new_oz = dot3(sample_pos_v - basic["pos_v"], basic["normal"])
    oz = new_oz if init else torch.minimum(oz, new_oz)
    if cfg.kernel == AO_KERNEL_VAO:
        v = calc_visibility(cfg, new_oz, s["sphere_start"], s["sphere_end"],
                            s["pdf"], basic["radius"])
        vis = v if init else torch.minimum(vis, v)
    else:
        v = torch.clamp(hbao_kernel(cfg, basic, sample_pos_v) / s["pdf"],
                        0.0, 1.0)
        vis = v if init else torch.maximum(vis, v)
    return vis, oz


def reset_sample(cfg, like):
    """Common.slang:485-490."""
    vis = torch.ones_like(like) if cfg.kernel == AO_KERNEL_VAO \
        else torch.zeros_like(like)
    return vis, torch.full_like(like, FLT_MAX)


def require_ray(cfg, basic, s, oz):
    """Common.slang:455-461."""
    if cfg.kernel == AO_KERNEL_VAO:
        return ((oz > s["sphere_start"] + const_radius(cfg, basic["radius"],
                                                       s["sphere_start"]))
                & (s["ss_radius"] > cfg.ss_radius_cutoff))
    return ((oz > torch.maximum(s["sphere_start"], basic["radius"] * 0.1))
            & (s["ss_radius"] > cfg.ss_radius_cutoff))


def eval_depth_sample(cam, cfg, basic, s, depth_tex, vis, oz, init: bool):
    """evalPrimary/DualVisibility: sample a depth texture at the snapped
    raster uv and fold it into (vis, oz) (Common.slang:432-505)."""
    d = sample_depth_at(depth_tex, s["raster_uv"])
    sample_pos_v = cam.uv_to_view_space(s["raster_uv"], d)
    return add_sample(cfg, basic, s, sample_pos_v, vis, oz, init)


def is_same_pixel(cfg, uv1, uv2):
    """Common.slang:129-134."""
    inv = _f32(cfg.inv_resolution, uv1.device)
    return (torch.abs(uv1 - uv2) < inv * 0.9).all(-1)


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


@functools.lru_cache(maxsize=8)
def dither_rotation_for(height: int, width: int, device):
    """(sin, cos) [height, width] of the tiled dither rotation angle
    noise * 2 * 3.141, evaluated on the host for the 16 entries of the
    4x4 table (CUDA's sin and cos round otherwise than the CPU's in the
    last bit) and tiled on `device`."""
    rot = torch.as_tensor(np.asarray(DITHER_4X4, np.float32)) * 2.0 * 3.141
    reps = (-(-height // 4), -(-width // 4))
    return tuple(torch.as_tensor(np.tile(f(rot).numpy(), reps)[
        :height, :width].copy(), device=device)
        for f in (torch.sin, torch.cos))


def dither_noise_for(height: int, width: int, *, device):
    """The 4x4 wrap-sampled rotation noise (SVAO.cpp:663-688), tiled."""
    reps = (-(-height // 4), -(-width // 4))
    return torch.as_tensor(np.tile(DITHER_4X4, reps)[:height, :width].copy(),
                           device=device)


def shift_axis_clamped(a, axis: int, off: int, lo: int | None = None,
                       hi: int | None = None):
    """out[..i..] = a[..clip(i + off, lo, hi)..] along `axis` (lo/hi
    default to the array bounds)."""
    n = a.shape[axis]
    lo = 0 if lo is None else lo
    hi = n - 1 if hi is None else hi
    idx = torch.clamp(torch.arange(n, device=a.device) + off, lo, hi)
    return a.index_select(axis, idx)


def shift2d_clamped(a, dy: int, dx: int):
    """out[y, x] = a[clamp(y + dy), clamp(x + dx)] for [H, W(, C)]."""
    return shift_axis_clamped(shift_axis_clamped(a, 0, dy), 1, dx)
