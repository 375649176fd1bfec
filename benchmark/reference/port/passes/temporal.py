"""TAA (counterpart of rtsdm_tpu/passes/temporal.py; the port's TemporalAO,
AOFlickerMask, BinaryDilation and AccumulatePass are not in this copy).

Reference: TAA/TAA.ps.slang (YCgCo variance clipping over the 3x3
neighbourhood and a Catmull-Rom history fetch along the longest
neighbouring motion vector).

History textures are resampled by the warp kernel's plain version
(ops/warp_cuda.py): TAA's Catmull-Rom mode evaluates the reference's nine
bilinear taps (_catmull_rom below) in the same order. Temporal state (the reference's persistent textures) is threaded
through the graph's state dict.
"""
from __future__ import annotations

import torch

from ..ops.ao import shift2d_clamped
from ..ops.warp_cuda import warp_resample, warp_resample_plain
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import rgb_to_ycgco, true_div, ycgco_to_rgb


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
