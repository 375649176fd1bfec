"""Small pipeline passes (counterpart of rtsdm_tpu/passes/
pipeline_misc.py): DownsamplePass."""
from __future__ import annotations

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import true_div


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
