"""Small pipeline passes (counterpart of rtsdm_tpu/passes/
pipeline_misc.py). Ported so far: RayMinMaxLength, DownsamplePass and
TemporalDepthPeel."""
from __future__ import annotations

import numpy as np
import torch

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import true_div


@register_pass("RayMinMaxLength")
class RayMinMaxLength(RenderPass):
    """Ray-interval length view (RayMinMaxLength.ps.slang): 0 where no ray
    was requested (rayMax 0), else max(rayMax - rayMin, 0) / 32, with the
    FLT_MAX rayMin clear read as 0."""

    SCHEMA = dict()

    def reflect(self, ctx):
        return (PassReflection().add_input("kRayMin").add_input("kRayMax")
                .add_output("length"))

    def execute(self, ctx, inputs, state=None):
        rmin = inputs["kRayMin"]
        rmax = inputs["kRayMax"]
        rmin = torch.where(rmin >= 1e37, 0.0, rmin)
        length = true_div(torch.clamp(rmax - rmin, min=0.0), 32.0)
        return {"length": torch.where(rmax != 0.0, length, 0.0)}, None


@register_pass("DownsamplePass")
class DownsamplePass(RenderPass):
    """Aligned block downsample (point/min/mean) feeding the quarter-res AO
    path of BASELINE config 4: the input is cropped to a multiple of the
    factor; 'point' keeps each block's centre-right texel, 'min' its
    minimum, and any other mode its mean."""

    SCHEMA = dict(factor=4, mode="point")

    def reflect(self, ctx):
        return PassReflection().add_input("input").add_output("output")

    def execute(self, ctx, inputs, state=None):
        x = inputs["input"]
        f = int(self.cfg["factor"])
        h, w = x.shape[:2]
        hp, wp = h - h % f, w - w % f
        x = x[:hp, :wp]
        if self.cfg["mode"] == "point":
            return {"output": x[f // 2::f, f // 2::f]}, None
        r = x.reshape((hp // f, f, wp // f, f) + x.shape[2:])
        if self.cfg["mode"] == "min":
            return {"output": r.amin((1, 3))}, None
        return {"output": true_div(r.sum((1, 3)), float(f * f))}, None


@register_pass("TemporalDepthPeel")
class TemporalDepthPeel(RenderPass):
    """Second depth layer from the reprojected previous frame
    (TemporalDepthPeel.cpp:140-144): the previous frame's linear depth,
    sampled bilinearly along the motion vectors (K10), counts where it lies at
    least minSeparationDistance behind this frame's; elsewhere, and on the
    first frame, the far plane. Output: non-linear depth, as DepthPeeling
    gives it."""

    SCHEMA = dict(minSeparationDistance=0.5)

    def reflect(self, ctx):
        return (PassReflection().add_input("linearZ").add_input("mvec")
                .add_output("depth2"))

    def init_state(self, ctx):
        return {"prev": None, "valid": False}

    @staticmethod
    def state_from_numpy(state, device) -> dict:
        """The JAX package's state ({"prev": [H, W], "valid": bool} as
        numpy arrays) as this pass's."""
        return {"prev": torch.as_tensor(np.array(state["prev"], np.float32),
                                        device=device),
                "valid": bool(state["valid"])}

    def execute(self, ctx, inputs, state=None):
        from . import temporal
        state = state or self.init_state(ctx)
        cam = ctx.scene.camera
        z = inputs["linearZ"]
        if state["valid"]:
            h, w = z.shape
            uv = temporal._grid_uv(h, w, z.device) + inputs["mvec"][..., :2]
            # K10's bilinear mode, as TemporalAO reprojects its AO
            # (temporal._bilinear's sample, bit for bit)
            prev = temporal.warp_resample(
                state["prev"][None].contiguous(),
                (uv[..., 0] * w).contiguous(),
                (uv[..., 1] * h).contiguous(), mode="bilinear")[0]
            # the previous depth counts as a second layer only if it lies
            # behind the first by minSeparationDistance
            # (TemporalDepthPeel.cpp:53, 140)
            sep = float(self.cfg["minSeparationDistance"])
            d2 = torch.where(prev > z + sep, prev, cam.far_z)
        else:
            d2 = cam.far_z.expand(z.shape)
        nl = cam.far_z * (d2 - cam.near_z) / (
            torch.clamp(d2, min=1e-6) * (cam.far_z - cam.near_z))
        return ({"depth2": torch.clamp(nl, 0.0, 1.0)},
                {"prev": z, "valid": True})
