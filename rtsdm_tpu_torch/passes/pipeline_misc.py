"""Small pipeline passes (counterpart of rtsdm_tpu/passes/
pipeline_misc.py). Ported so far: RayMinMaxLength."""
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
