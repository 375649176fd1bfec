"""CrossBilateralBlur (counterpart of rtsdm_tpu/passes/blur.py): separable
HBAO+-style bilateral blur with depth-slope correction (reference
CrossBilateralBlur.ps.slang:28-88), taps clamped to the guard-band interior
(CrossBilateralBlur.cpp:132-148)."""
from __future__ import annotations

import torch

from ..ops.ao import shift_axis_clamped
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass


def cross_bilateral_blur_1d(ao, depth, axis: int, kernel_radius: int,
                            better_slope: bool, lo: int, hi: int):
    """One separable direction of the blur (ps.slang:59-88). ao, depth:
    [H, W]; axis 1 = horizontal, 0 = vertical."""
    r = kernel_radius
    blur_sigma = (r + 1.0) * 0.5
    blur_falloff = 1.0 / (2.0 * blur_sigma * blur_sigma)
    sharpness = 16.0

    def tap(a, off):
        return shift_axis_clamped(a, axis, off, lo, hi)

    depth_c = depth
    ao_sum = ao
    w_sum = torch.ones_like(ao)
    # slope from the two immediate neighbours (ps.slang:80-82)
    slope_l = depth_c - tap(depth, -1)
    slope_r = tap(depth, +1) - depth_c
    min_slope = torch.where(torch.abs(slope_l) < torch.abs(slope_r),
                            slope_l, slope_r)
    for sign in (+1, -1):
        depth_slope = sign * min_slope
        for d in range(1, r + 1):
            s_ao = tap(ao, sign * d)
            s_depth = tap(depth, sign * d)
            if d == 1 and not better_slope:
                depth_slope = s_depth - depth_c
            sd = s_depth - depth_slope * d
            dz = torch.abs(sd - depth_c) * sharpness
            dz = dz * 12.0 / torch.clamp(depth_c, min=1e-6)
            w = torch.exp2(-(d * d) * blur_falloff - dz * dz)
            ao_sum = ao_sum + w * s_ao
            w_sum = w_sum + w
    return ao_sum / w_sum


@register_pass("CrossBilateralBlur")
class CrossBilateralBlur(RenderPass):
    SCHEMA = dict(kernelRadius=4, betterSlope=True)

    def reflect(self, ctx):
        return (PassReflection().add_input("color")
                .add_input("linear depth").add_output("colorOut"))

    def execute(self, ctx, inputs, state=None):
        ao = inputs["color"]
        depth = inputs["linear depth"]
        r = int(self.cfg["kernelRadius"])
        better = bool(self.cfg["betterSlope"])
        g = ctx.guard_band
        lo_x, hi_x = g, ctx.width - g - 1
        lo_y, hi_y = g, ctx.height - g - 1

        def blur2d(a):
            a = cross_bilateral_blur_1d(a, depth, 1, r, better, lo_x, hi_x)
            return cross_bilateral_blur_1d(a, depth, 0, r, better, lo_y,
                                           hi_y)

        if ao.dim() == 3:
            out = torch.stack([blur2d(ao[..., c])
                               for c in range(ao.shape[-1])], -1)
        else:
            out = blur2d(ao)
        return {"colorOut": out}, None
