"""Texture system (counterpart of rtsdm_tpu/scene/textures.py).

Material textures are baked at scene build into one page stack
[N, PAGE, PAGE, 3] float32 (a material carries a page index, -1 =
untextured) and the environment is a lat-long [He, We, 3] map; both are
sampled once per pixel in the shading passes. The numpy bakers are the
reference package's, copied so both packages bake identical pages.

On the card both samplers go through the warp kernel (K10,
ops/warp_cuda.py): the env map with x-wrap, the pages as one tall atlas of
wrap-padded pages (the wrap addressing folds into the one-texel pad, so a
bilinear tap never crosses into a neighbouring page).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.warp_cuda import warp_resample
from ..utils.math import dot3, true_div

PAGE = 64  # texels per page side; 64*64*3*4B = 48 KiB per page


# ---------------------------------------------------------------------------
# host-side baking
# ---------------------------------------------------------------------------

def _resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """Area-average / bilinear resize of [h,w,3] float to [size,size,3]
    (host-side, scene build only)."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img.astype(np.float32)
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - fx) + im[y0][:, x1] * fx
    bot = im[y1][:, x0] * (1 - fx) + im[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    if h > 2 * size and w > 2 * size:  # crude area prefilter for big shrinks
        k = max(h // size, w // size)
        kh, kw = (h // k) * k, (w // k) * k
        box = im[:kh, :kw].reshape(kh // k, k, kw // k, k, 3).mean((1, 3))
        return _resize_area(box, size)
    return out


def build_texture_pages(images) -> np.ndarray | None:
    """Bake a list of [h,w,3]-ish host images (float 0..1 or uint8) into the
    fixed page stack [N, PAGE, PAGE, 3] float32. Returns None for []."""
    if not images:
        return None
    pages = []
    for img in images:
        a = np.asarray(img)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        if a.ndim == 2:
            a = np.repeat(a[..., None], 3, axis=-1)
        if a.shape[-1] == 4:
            a = a[..., :3]
        pages.append(_resize_area(a.astype(np.float32), PAGE))
    return np.stack(pages, axis=0)


def checkerboard(c0=(0.9, 0.9, 0.9), c1=(0.2, 0.2, 0.2), tiles=8):
    """Procedural checker page (scene-build helper)."""
    yy, xx = np.meshgrid(np.arange(PAGE), np.arange(PAGE), indexing="ij")
    m = (((yy * tiles // PAGE) + (xx * tiles // PAGE)) % 2).astype(np.float32)
    return (np.asarray(c0, np.float32) * (1 - m[..., None])
            + np.asarray(c1, np.float32) * m[..., None])


def noise_texture(seed=0, base=(1.0, 1.0, 1.0), amp=0.4):
    """Value-noise page: smooth LUMINANCE variation around ``base`` (facade/
    dirt stand-in). Single-channel noise so the material's base color tints
    it instead of independent RGB blotches."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((8, 8, 1), np.float32)
    fine = _resize_area(np.repeat(coarse, 3, -1), PAGE)[..., :1]
    return np.clip(np.asarray(base, np.float32)[None, None]
                   * (1.0 + amp * (fine - 0.5)), 0.0, 1.0)


def latlong_sky(he=64, we=128, horizon=(0.8, 0.75, 0.7), zenith=(0.25, 0.45, 0.8),
                sun_dir=(0.35, 0.8, 0.3), sun_intensity=12.0, sun_sharp=400.0):
    """Analytic sky baked to a lat-long env texture [he,we,3]
    (ref Scene/Lights/EnvMap.cpp lat-long layout; the probe itself is
    procedural because media files don't ship)."""
    theta = (np.arange(he) + 0.5) / he * np.pi           # 0..pi from +Y
    phi = (np.arange(we) + 0.5) / we * 2.0 * np.pi - np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([st * np.cos(phi)[None, :],
                  np.cos(theta)[:, None] * np.ones((1, we)),
                  st * np.sin(phi)[None, :]], axis=-1)
    up = np.clip(d[..., 1], -1.0, 1.0)
    t = (up * 0.5 + 0.5)[..., None]
    sky = np.asarray(horizon, np.float32) * (1 - t) + np.asarray(zenith, np.float32) * t
    s = np.asarray(sun_dir, np.float32)
    s = s / np.linalg.norm(s)
    cos_sun = np.clip((d * s).sum(-1), 0.0, 1.0)
    sun = sun_intensity * np.exp(sun_sharp * (cos_sun - 1.0))[..., None]
    return (sky + sun * np.array([1.0, 0.95, 0.85], np.float32)).astype(np.float32)


# ---------------------------------------------------------------------------
# sampling (shading passes only)
# ---------------------------------------------------------------------------

def _as_grid(a):
    """[..., k] -> [rows, cols, k] for the warp kernel's 2-d sample grid."""
    lead = a.shape[:-1]
    if len(lead) == 2:
        return a
    return a.reshape(1, -1, a.shape[-1])


def sample_pages(pages, page_idx, uv, fallback: float = 1.0):
    """Bilinear, wrap-addressed sample of the page stack.

    pages [N, PAGE, PAGE, 3]; page_idx [...] int32 (-1 = untextured ->
    `fallback`); uv [..., 2]. Returns [..., 3]."""
    n = pages.shape[0]
    lead = uv.shape[:-1]
    wrap = torch.remainder(torch.arange(-1, PAGE + 1, device=pages.device),
                           PAGE)
    padded = pages[:, wrap][:, :, wrap]                 # [N, PAGE+2, PAGE+2, 3]
    atlas = padded.permute(3, 0, 1, 2).reshape(3, n * (PAGE + 2), PAGE + 2)
    g = _as_grid(uv)
    pi = torch.clamp(page_idx.reshape(g.shape[:2]), 0, n - 1)
    xl = torch.remainder(g[..., 0] * PAGE - 0.5, PAGE)
    yl = torch.remainder(g[..., 1] * PAGE - 0.5, PAGE)
    out = warp_resample(atlas.contiguous(), xl + 1.5,
                        yl + 1.5 + pi.to(torch.float32) * (PAGE + 2),
                        mode="bilinear")
    out = out.permute(1, 2, 0).reshape(lead + (3,))
    return torch.where((page_idx >= 0)[..., None], out, fallback)


def sample_env(env_map, dirs):
    """Lat-long environment lookup by direction [..., 3] (EnvMap.cpp
    dirToUv): theta from +y, phi around y; bilinear, wrapped in phi,
    clamped in theta. Returns [..., 3]."""
    he, we = env_map.shape[0], env_map.shape[1]
    norm = torch.sqrt(dot3(dirs, dirs))[..., None]
    d = dirs / torch.clamp(norm, min=1e-8)
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    v = true_div(theta, math.pi) * he - 0.5
    u = true_div(phi + math.pi, 2.0 * math.pi) * we - 0.5
    lead = dirs.shape[:-1]
    g = _as_grid(torch.stack([u, v], -1))
    tex = env_map.permute(2, 0, 1).contiguous()
    out = warp_resample(tex, g[..., 0] + 0.5, g[..., 1] + 0.5,
                        mode="bilinear", wrap_x=True)
    return out.permute(1, 2, 0).reshape(lead + (3,))
