"""Texture resample (K10): the wrapper of csrc/warp.cu and its plain
PyTorch version (counterpart of rtsdm_tpu/ops/warp_pallas.py:
warp_resample_pallas).

A planar float32 texture [C, H, W] is sampled at per-pixel positions
sx, sy [HO, WO] in pixel units (texel centres at +0.5): nearest, bilinear
or Catmull-Rom, clamped to the edge or wrapped in x. The TPU kernel needed a
fallback plane where a block's tap spread left its VMEM region; a GPU
thread can read any texel, so there is none here and the contract is the
XLA samplers of the reference (passes/temporal.py:_bilinear and
_catmull_rom, scene/textures.py:sample_env's gather): the same operations
in the same order, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr, stream_of

MODES = {"nearest": 0, "bilinear": 1, "catmull_rom": 2}


def launch_key(mode: str) -> str:
    """The key under which _build.LAUNCHES counts K10's launches in `mode`."""
    return f"rtsdm_warp_resample:{mode}"


def _tap_index(i, n: int, wrap: bool):
    return torch.remainder(i, n) if wrap else torch.clamp(i, 0, n - 1)


def _bilinear_at(tex, x, y, wrap_x: bool):
    """Bilinear sample of [C, H, W] at continuous texel coordinates x, y
    (texel centres at integers) -> [C, ...]: the reference's
    (t00 (1-fx) + t01 fx)(1-fy) + (t10 (1-fx) + t11 fx) fy."""
    h, w = tex.shape[1:]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)
    xa, xb = _tap_index(xi, w, wrap_x), _tap_index(xi + 1, w, wrap_x)
    ya, yb = _tap_index(yi, h, False), _tap_index(yi + 1, h, False)
    a = tex[:, ya, xa] * (1 - fx) + tex[:, ya, xb] * fx
    b = tex[:, yb, xa] * (1 - fx) + tex[:, yb, xb] * fx
    return a * (1 - fy) + b * fy


def warp_resample_plain(tex, sx, sy, mode: str = "catmull_rom",
                        wrap_x: bool = False):
    """Plain PyTorch version of K10; returns [C, HO, WO]."""
    h, w = tex.shape[1:]
    if mode == "nearest":
        xi = _tap_index(torch.floor(sx).to(torch.int64), w, wrap_x)
        yi = _tap_index(torch.floor(sy).to(torch.int64), h, False)
        return tex[:, yi, xi]
    if mode == "bilinear":
        return _bilinear_at(tex, sx - 0.5, sy - 0.5, wrap_x)
    # Catmull-Rom as nine bilinear taps (TAA.ps.slang:45-76), evaluated as
    # temporal._catmull_rom does, each tap going through uv = p / size and
    # back (p / w * w - 0.5)
    wt = torch.full((), float(w), device=tex.device)
    ht = torch.full((), float(h), device=tex.device)
    tcx = torch.floor(sx - 0.5) + 0.5
    tcy = torch.floor(sy - 0.5) + 0.5
    ws = []
    for tc, p in ((tcx, sx), (tcy, sy)):
        f = p - tc
        f2, f3 = f * f, f * f * f
        w0 = f2 - 0.5 * (f3 + f)
        w1 = 1.5 * f3 - 2.5 * f2 + 1.0
        w3 = 0.5 * (f3 - f2)
        w2 = 1.0 - w0 - w1 - w3
        w12 = w1 + w2
        ws.append(((tc - 1.0, w0),
                   (tc + w2 / torch.where(w12 == 0.0, 1.0, w12), w12),
                   (tc + 2.0, w3)))
    out = None
    for px, wx in ws[0]:
        for py, wy in ws[1]:
            s = _bilinear_at(tex, (px / wt) * w - 0.5, (py / ht) * h - 0.5,
                             wrap_x) * (wx * wy)
            out = s if out is None else out + s
    return out


def check_offsets(tex, sx) -> None:
    """K10 computes 32-bit offsets: ValueError where the texture `tex` or
    the target (its channels times sx's pixels) holds 2^31 values or
    more."""
    if tex.numel() >= 2**31 or tex.shape[0] * sx.numel() >= 2**31:
        raise ValueError("warp_resample: the texture and the output must "
                         "each hold fewer than 2^31 values (32-bit "
                         "offsets)")


def warp_resample(tex, sx, sy, mode: str = "catmull_rom",
                  wrap_x: bool = False):
    """K10: resample planar float32 `tex` [C, H, W] at sx, sy [HO, WO]
    (pixel units, texel centres at +0.5) -> [C, HO, WO]. A CUDA tensor
    launches the kernel (counted per mode, launch_key) after check_offsets,
    a CPU tensor takes the plain version."""
    if mode not in MODES:
        raise ValueError(f"warp_resample: unknown mode {mode!r}")
    if tex.dim() != 3 or sx.shape != sy.shape or sx.dim() != 2:
        raise ValueError("warp_resample: tex [C,H,W], sx and sy [HO,WO]")
    for t, name in ((tex, "tex"), (sx, "sx"), (sy, "sy")):
        if t.dtype != torch.float32:
            raise ValueError(f"warp_resample: {name} must be float32")
    if tex.is_cuda:
        tex, sx, sy = tex.contiguous(), sx.contiguous(), sy.contiguous()
        check_offsets(tex, sx)
        c, h, w = tex.shape
        ho, wo = sx.shape
        out = torch.empty((c, ho, wo), dtype=torch.float32, device=tex.device)
        launch("rtsdm_warp_resample", ptr(tex), ptr(sx), ptr(sy), c, h, w,
               ho, wo, MODES[mode], int(wrap_x), ptr(out), stream_of(tex),
               key=launch_key(mode))
        return out
    if tex.device.type != "cpu":
        raise RuntimeError(f"warp_resample: unsupported device {tex.device}")
    return warp_resample_plain(tex, sx, sy, mode, wrap_x)
