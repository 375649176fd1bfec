"""Temporal passes: TAA, TemporalAO, AOFlickerMask, BinaryDilation and
AccumulatePass (counterpart of rtsdm_tpu/passes/temporal.py).

References: TAA/TAA.ps.slang (YCgCo variance clipping over the 3x3
neighbourhood and a Catmull-Rom history fetch along the longest
neighbouring motion vector), TemporalAO/TemporalAO.ps.slang (motion-vector
reprojection with a relative-depth reject), AOFlickerMask/
AOFlickerMask.ps.slang (plane-difference stability mask),
BinaryDilation/BinaryDilation.ps.slang and AccumulatePass.h:44.

History textures are resampled by the warp kernel (K10, ops/warp_cuda.py),
which on a CPU tensor runs its plain version: TAA's Catmull-Rom mode
evaluates the reference's nine bilinear taps (_catmull_rom below) in the
same order; TemporalAO fetches depth and history with its nearest mode
(floor of the position, then the clamp: the reference's CPU path
truncates, and the two agree after the clamp) and the AO with its bilinear
mode. Temporal state (the reference's persistent textures) is threaded
through the graph's state dict.
"""
from __future__ import annotations

import torch

from ..ops.ao import shift2d_clamped
from ..ops.warp_cuda import warp_resample, warp_resample_plain
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import (normalize, rgb_to_ycgco, saturate, transform_point,
                          transform_vector, true_div, ycgco_to_rgb)


def _grid_uv(h: int, w: int, device):
    """Pixel-centre uv [H, W, 2]."""
    xs = true_div(torch.arange(w, dtype=torch.float32, device=device) + 0.5,
                  w)
    ys = true_div(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
                  h)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def _shift(a, dy: int, dx: int):
    """Edge-clamped neighbour fetch of [H, W, ...]."""
    return shift2d_clamped(a, dy, dx)


def _bilinear(tex, uv):
    """[H, W, C] linear sample at uv [..., 2] (temporal._bilinear)."""
    h, w = tex.shape[:2]
    out = warp_resample_plain(tex.permute(2, 0, 1),
                              uv[..., 0] * w, uv[..., 1] * h, "bilinear")
    return out.permute(1, 2, 0)


def _catmull_rom(tex, sample_pos):
    """9-tap Catmull-Rom resample of [H, W, C] at pixel positions [..., 2]
    (TAA.ps.slang:45-76; K10's plain version in this mode)."""
    out = warp_resample_plain(tex.permute(2, 0, 1), sample_pos[..., 0],
                              sample_pos[..., 1], "catmull_rom")
    return out.permute(1, 2, 0)


@register_pass("TAA")
class TAA(RenderPass):
    SCHEMA = dict(alpha=0.1, colorBoxSigma=0.5, antiFlicker=True)

    def reflect(self, ctx):
        return (PassReflection().add_input("colorIn").add_input("motionVecs")
                .add_output("colorOut"))

    def init_state(self, ctx):
        return {"prev": None, "valid": False}

    def execute(self, ctx, inputs, state=None):
        color = inputs["colorIn"][..., :3]
        mvec = inputs["motionVecs"][..., :2]
        h, w = color.shape[:2]
        state = state or self.init_state(ctx)
        prev = state["prev"] if state["valid"] else color

        c = rgb_to_ycgco(color)
        avg = c
        var = c * c
        # 3x3 neighbourhood colour box + longest motion vector
        # (ps.slang:81-127)
        motion = mvec
        m_len = (mvec * mvec).sum(-1)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                cn = rgb_to_ycgco(_shift(color, dy, dx))
                avg = avg + cn
                var = var + cn * cn
                mn = _shift(mvec, dy, dx)
                ln = (mn * mn).sum(-1)
                motion = torch.where((ln > m_len)[..., None], mn, motion)
                m_len = torch.maximum(m_len, ln)
        avg = true_div(avg, 9.0)
        var = true_div(var, 9.0)
        sigma = torch.sqrt(torch.clamp(var - avg * avg, min=0.0))
        box = float(self.cfg["colorBoxSigma"])
        cmin = avg - box * sigma
        cmax = avg + box * sigma

        uv = _grid_uv(h, w, color.device)
        wh = torch.tensor([w, h], dtype=torch.float32, device=color.device)
        sample_pos = (uv + motion) * wh
        hist_rgb = warp_resample(prev.permute(2, 0, 1).contiguous(),
                                 sample_pos[..., 0].contiguous(),
                                 sample_pos[..., 1].contiguous(),
                                 mode="catmull_rom")
        hist = rgb_to_ycgco(hist_rgb.permute(1, 2, 0))

        alpha = float(self.cfg["alpha"])
        if self.cfg["antiFlicker"]:
            # Karis anti-flicker (ps.slang:136-143)
            dist = torch.minimum(torch.abs(cmin[..., 0] - hist[..., 0]),
                                 torch.abs(cmax[..., 0] - hist[..., 0]))
            denom = dist + cmax[..., 0] - cmin[..., 0]
            alpha = torch.clamp((alpha * dist) / torch.clamp(denom, min=1e-8),
                                0.0, 1.0)[..., None]
        hist = torch.minimum(torch.maximum(hist, cmin), cmax)
        out = ycgco_to_rgb(hist + (c - hist) * alpha)
        return {"colorOut": out}, {"prev": out, "valid": True}


@register_pass("TemporalAO")
class TemporalAO(RenderPass):
    SCHEMA = dict(enabled=True, useStableMask=True)

    def reflect(self, ctx):
        return (PassReflection().add_input("aoIn").add_input("linearZ")
                .add_input("mvec").add_input("stableMask", optional=True)
                .add_output("aoOut"))

    def init_state(self, ctx):
        return {"valid": False}

    def execute(self, ctx, inputs, state=None):
        ao = inputs["aoIn"]
        if ao.dim() == 3:
            ao = ao[..., 0]
        if not self.cfg["enabled"]:
            return {"aoOut": ao}, state
        state = state or self.init_state(ctx)
        cam = ctx.scene.camera
        depth = inputs["linearZ"]
        h, w = depth.shape
        dev = depth.device
        if not state["valid"]:
            # no history yet: every pixel is rejected (ps.slang:88-95)
            return ({"aoOut": ao},
                    {"prev_ao": ao, "prev_depth": depth,
                     "history": torch.ones((h, w), dtype=torch.int32,
                                           device=dev),
                     "prev_view": cam.view_mat, "valid": True})
        prev_uv = _grid_uv(h, w, dev) + inputs["mvec"][..., :2]
        g = ctx.guard_band
        uv_min = torch.tensor([g + 0.5] * 2, dtype=torch.float32,
                              device=dev) \
            / torch.tensor([w, h], dtype=torch.float32, device=dev)
        uv_max = 1.0 - uv_min
        in_area = ((prev_uv >= uv_min) & (prev_uv <= uv_max)).all(-1)

        spx = (prev_uv[..., 0] * w).contiguous()
        spy = (prev_uv[..., 1] * h).contiguous()
        near = warp_resample(
            torch.stack([state["prev_depth"],
                         state["history"].to(torch.float32)]),
            spx, spy, mode="nearest")
        prev_raw, prev_n = near[0], near[1]
        # reproject the previous view position into the current view
        # (prevViewToCurView = viewMat * inverse(prevViewMat), ps.slang:84-86)
        prev_pos = cam.uv_to_view_space(prev_uv, prev_raw)
        m = cam.view_mat @ torch.linalg.inv_ex(state["prev_view"]).inverse
        prev_depth = -transform_point(m, prev_pos)[..., 2]

        stable = inputs.get("stableMask")
        if stable is not None and self.cfg["useStableMask"]:
            is_stable = stable != 0
        else:
            is_stable = torch.zeros_like(in_area)
        rel = torch.abs(1.0 - prev_depth / torch.clamp(depth, min=1e-6))
        accept = in_area & (rel < 0.1) & ~is_stable

        prev_ao = warp_resample(state["prev_ao"][None].contiguous(), spx,
                                spy, mode="bilinear")[0]
        merged = (prev_n * prev_ao + ao) / (prev_n + 1.0)
        out = torch.where(accept, merged, ao)
        n_out = torch.where(accept, torch.clamp(prev_n.to(torch.int32) + 1,
                                                max=30), 1)
        return ({"aoOut": out},
                {"prev_ao": out, "prev_depth": depth, "history": n_out,
                 "prev_view": cam.view_mat, "valid": True})


@register_pass("AOFlickerMask")
class AOFlickerMask(RenderPass):
    """1 where the surface is geometrically continuous (stable), 0 where
    the AO may flicker (AOFlickerMask.ps.slang:44-82); int32 where the
    reference package keeps uint32 (the values are 0 and 1)."""

    SCHEMA = dict()

    def reflect(self, ctx):
        return (PassReflection().add_input("linearZ").add_input("normalW")
                .add_output("mask"))

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        z = inputs["linearZ"]
        h, w = z.shape
        dev = z.device
        n_v = normalize(transform_vector(cam.view_mat,
                                         inputs["normalW"][..., :3]))
        p = cam.uv_to_view_space(_grid_uv(h, w, dev), z)

        def plane_diff(dy, dx):
            xs = torch.clamp(torch.arange(w, device=dev) + dx, 0, w - 1)
            ys = torch.clamp(torch.arange(h, device=dev) + dy, 0, h - 1)
            uu = torch.stack(
                [saturate(true_div(xs.to(torch.float32) + 0.5, w))
                 [None, :].expand(h, w),
                 saturate(true_div(ys.to(torch.float32) + 0.5, h))
                 [:, None].expand(h, w)], -1)
            d = cam.uv_to_view_space(uu, _shift(z, dy, dx)) - p
            d = d / torch.clamp(torch.sqrt((d * d).sum(-1, keepdim=True)),
                                min=1e-8)
            return torch.abs((d * n_v).sum(-1))

        dx = torch.minimum(plane_diff(0, 1), plane_diff(0, -1))
        dy = torch.minimum(plane_diff(1, 0), plane_diff(-1, 0))
        return {"mask": ((dx <= 0.1) & (dy <= 0.1)).to(torch.int32)}, None


@register_pass("BinaryDilation")
class BinaryDilation(RenderPass):
    """min or max over the gathered cross neighbourhood
    (BinaryDilation.ps.slang:19-37; the offsets approximate the
    reference's rotated 4 x (2x2) gather pattern, as the reference package
    does)."""

    SCHEMA = dict(op="min")
    OFFSETS = ((3, 1), (-1, 3), (-3, -1), (1, -3), (1, 1), (1, -1), (-1, 1),
               (-1, -1), (0, 1), (0, -1), (1, 0), (-1, 0))

    def reflect(self, ctx):
        return PassReflection().add_input("input").add_output("output")

    def execute(self, ctx, inputs, state=None):
        a = inputs["input"]
        op = torch.minimum if self.cfg["op"] == "min" else torch.maximum
        out = a
        for dy, dx in self.OFFSETS:
            out = op(out, _shift(a, dy, dx))
        return {"output": out}, None


@register_pass("AccumulatePass")
class AccumulatePass(RenderPass):
    """Running average for converged references (AccumulatePass.h:44):
    the sum of every input so far over the frame count, which maxFrameCount
    caps as the reference package does."""

    SCHEMA = dict(enabled=True, outputSize="Default", autoReset=True,
                  precisionMode="Single", maxFrameCount=0, overflowMode="Stop")

    def reflect(self, ctx):
        return PassReflection().add_input("input").add_output("output")

    def init_state(self, ctx):
        return {"sum": None, "count": 0}

    def execute(self, ctx, inputs, state=None):
        x = inputs["input"]
        if not self.cfg["enabled"]:
            return {"output": x}, state
        state = state or self.init_state(ctx)
        s = x if state["sum"] is None else state["sum"] + x
        cnt = state["count"] + 1
        maxf = int(self.cfg["maxFrameCount"])
        if maxf > 0:
            cnt = min(cnt, maxf)
        return {"output": true_div(s, float(cnt))}, {"sum": s, "count": cnt}
