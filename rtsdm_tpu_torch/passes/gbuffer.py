"""G-buffer raster pass (counterpart of rtsdm_tpu/passes/gbuffer.py;
reference GBufferRaster, GBuffer.cpp:39-50): one visibility-buffer raster,
then every channel from one attribute fetch."""
from __future__ import annotations

import torch

from ..ops.raster import fetch_vertex_attributes, rasterize
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import normalize, transform_point


def raster_gbuffer(scene, width: int, height: int, cull: str = "back",
                   apply_jitter: bool = True):
    """Raster + channel materialization. Returns depth (NDC), posW (+hit
    flag), normW, faceNormalW, texC, mvec, mtlData, tri_id, bary."""
    cam = scene.camera
    jx = cam.jitter_x if apply_jitter else 0.0
    jy = cam.jitter_y if apply_jitter else 0.0
    vis = rasterize(cam.view_proj_no_jitter, scene.positions, width=width,
                    height=height, jitter_x=jx, jitter_y=jy, cull=cull)
    tid, bary = vis["tri_id"], vis["bary"]
    hit = tid >= 0
    pos_w, norm_w, tex_c, face_n, mtl = fetch_vertex_attributes(
        tid, bary, [scene.positions, scene.normals, scene.texcoords],
        [scene.face_normals(), scene.material_id])
    norm_w = torch.where(hit[..., None], normalize(norm_w), 0.0)
    face_n = torch.where(hit[..., None], face_n, 0.0)
    mtl = torch.where(hit, mtl, -1)

    # motion vectors: texC + mvec = previous-frame uv, from the no-jitter
    # matrices (static geometry: last frame's position is this frame's)
    h, w = tid.shape
    prev_clip = transform_point(cam.prev_view_proj_no_jitter, pos_w)
    prev_w = torch.where(prev_clip[..., 3] == 0.0, 1.0, prev_clip[..., 3])
    prev_uv = torch.stack([prev_clip[..., 0] / prev_w * 0.5 + 0.5,
                           0.5 - prev_clip[..., 1] / prev_w * 0.5], -1)
    dev = tid.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    mvec = torch.where(hit[..., None], prev_uv - torch.stack([gx, gy], -1),
                       0.0)
    return {
        "depth": vis["depth"],
        "posW": torch.cat([pos_w, hit[..., None].to(torch.float32)], -1),
        "normW": norm_w,
        "faceNormalW": face_n,
        "texC": tex_c,
        "mvec": mvec,
        "mtlData": mtl.to(torch.int32),
        "tri_id": tid,
        "bary": bary,
    }


@register_pass("GBufferRaster")
class GBufferRaster(RenderPass):
    """reference Source/RenderPasses/GBuffer/GBufferRaster.cpp. Only the
    Center sample pattern is ported (ROADMAP queue 1: sample patterns come
    with TAA)."""

    SCHEMA = dict(samplePattern="Center", cull="Back")
    CHANNELS = ("depth", "posW", "normW", "faceNormalW", "texC", "mvec",
                "mtlData", "tri_id", "bary")

    def reflect(self, ctx):
        r = PassReflection()
        for c in self.CHANNELS:
            r.add_output(c)
        return r

    def execute(self, ctx, inputs, state=None):
        if self.cfg["samplePattern"] not in ("Center", None, ""):
            raise NotImplementedError(
                "GBufferRaster: only samplePattern='Center' is ported "
                "(ROADMAP queue 1, item 10)")
        return raster_gbuffer(ctx.scene, ctx.width, ctx.height,
                              cull=self.cfg["cull"].lower()), None
