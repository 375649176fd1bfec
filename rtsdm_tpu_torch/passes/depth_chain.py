"""Depth-chain passes of the SVAO slice (counterpart of
rtsdm_tpu/passes/depth_chain.py): LinearizeDepth (Linearize.ps.slang) and
CompressNormals (CompressNormals.cpp:77-78)."""
from __future__ import annotations

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import encode_normal_2x16, normalize, transform_vector


@register_pass("LinearizeDepth")
class LinearizeDepth(RenderPass):
    SCHEMA = dict(depthFormat="R32Float")

    def reflect(self, ctx):
        return PassReflection().add_input("depth").add_output("linearDepth")

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        return {"linearDepth": cam.linearize_depth(inputs["depth"])}, None


@register_pass("CompressNormals")
class CompressNormals(RenderPass):
    """Octahedral 2x16 normal packing; viewSpace=True converts world->view
    first (what SVAO's loadNormal expects, Common.slang:98-103). The 2x8
    packing is not ported (ROADMAP queue 1, item 5)."""

    SCHEMA = dict(viewSpace=True, use16Bit=True)

    def reflect(self, ctx):
        return PassReflection().add_input("normalW").add_output("normalOut")

    def execute(self, ctx, inputs, state=None):
        if not self.cfg["use16Bit"]:
            raise NotImplementedError("CompressNormals: use16Bit=False "
                                      "(2x8 packing) is not ported")
        n = inputs["normalW"][..., :3]
        if self.cfg["viewSpace"]:
            n = transform_vector(ctx.scene.camera.view_mat, n)
        return {"normalOut": encode_normal_2x16(normalize(n))}, None
