"""Depth-chain passes (counterpart of rtsdm_tpu/passes/depth_chain.py):
LinearizeDepth (Linearize.ps.slang), GuardBand (GuardBand.cpp:58-100) and
CompressNormals (CompressNormals.cpp:77-78). DepthPeeling is registered so
graphs that wire it build, but it raises if it runs: it needs the raster's
depth floor, which the CUDA raster does not have yet. SingleDepth SVAO
never runs it (depth2 is an unused input, so the graph prunes the pass)."""
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


@register_pass("DepthPeeling")
class DepthPeeling(RenderPass):
    SCHEMA = dict(cullMode="Back", depthFormat="D32Float",
                  minSeparationDistance=0.01, maxPerTile=256)

    def reflect(self, ctx):
        return PassReflection().add_input("linearZ").add_output("depth2")

    def execute(self, ctx, inputs, state=None):
        raise NotImplementedError(
            "DepthPeeling: the second depth layer needs the raster's depth "
            "floor, which is not ported yet (ROADMAP queue 1, item 5)")


@register_pass("GuardBand")
class GuardBand(RenderPass):
    """Writes guardBand and uvMin/uvMax into the graph dictionary
    (GuardBand.cpp:58-66). The renderer grows the render resolution by
    2 * guardBand; consumers read dictionary['guardBand']."""

    SCHEMA = dict(guardBand=0)

    def execute(self, ctx, inputs, state=None):
        g = int(self.cfg["guardBand"])
        ctx.dictionary["guardBand"] = g
        ctx.dictionary["guardBand.uvMin"] = ((g + 0.5) / ctx.width,
                                             (g + 0.5) / ctx.height)
        ctx.dictionary["guardBand.uvMax"] = ((ctx.width - g - 0.5) / ctx.width,
                                             (ctx.height - g - 0.5)
                                             / ctx.height)
        return {}, None


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
