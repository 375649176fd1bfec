"""Small pipeline passes (counterpart of rtsdm_tpu/passes/
pipeline_misc.py). Ported so far: RayMinMaxLength and DownsamplePass."""
from __future__ import annotations

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
