"""Depth-chain passes (counterpart of rtsdm_tpu/passes/depth_chain.py):
LinearizeDepth (Linearize.ps.slang), DepthPeeling (DepthPeeling.3d.slang:
43-55), GuardBand (GuardBand.cpp:58-100) and CompressNormals
(CompressNormals.cpp:77-78)."""
from __future__ import annotations

from ..ops.raster import rasterize
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
    """Second depth layer: re-raster the scene, discarding fragments whose
    view depth is at most the first layer's linearZ + minSeparation (K1
    with its depth floor). depth2 is NON-linear NDC depth, like the
    G-buffer's. maxPerTile is accepted and without effect, as in
    GBufferRaster: the CUDA raster keeps no per-tile list cap."""

    SCHEMA = dict(cullMode="Back", depthFormat="D32Float",
                  minSeparationDistance=0.01, maxPerTile=256)

    def reflect(self, ctx):
        return PassReflection().add_input("linearZ").add_output("depth2")

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        vis = rasterize(cam.view_proj_no_jitter, ctx.scene.positions,
                        width=ctx.width, height=ctx.height,
                        jitter_x=cam.jitter_x, jitter_y=cam.jitter_y,
                        cull=self.cfg["cullMode"].lower(),
                        depth_floor=inputs["linearZ"],
                        min_separation=float(
                            self.cfg["minSeparationDistance"]))
        return {"depth2": vis["depth"]}, None


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
    packing is not ported (ROADMAP queue 1, item 7)."""

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
