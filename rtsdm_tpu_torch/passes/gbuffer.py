"""G-buffer raster pass (counterpart of rtsdm_tpu/passes/gbuffer.py;
reference GBufferRaster, GBuffer.cpp:39-50): one visibility-buffer raster,
then every channel from one attribute fetch."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.profiler import profile_scope
from ..ops.raster import attr_table, fetch_vertex_attributes, rasterize
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import normalize, transform_point, true_div
from ..utils.sampling import sample_pattern_offsets


# the G-buffer's attribute tables (attribute_table): {(id, _version) of
# each source tensor: (the sources, their AttrTable)}
_ATTR_TABLES: dict = {}
_ATTR_TABLES_MAX = 4


def attribute_table(scene):
    """The AttrTable of the G-buffer's attributes (positions, normals,
    texcoords and, where the scene has them, prev_positions interpolated;
    face normals and material id flat), kept while its sources are the
    same tensors at the same version: a static scene's geometry never
    changes, and a frame's jittered scene (Scene.with_camera) shares its
    tensors. An in-place edit of any of them builds the table anew.
    Animated geometry is new every frame: its newest table is kept (the
    frame's second raster reads it) and those of its earlier frames go."""
    src = (scene.positions, scene.normals, scene.texcoords,
           scene.material_id)
    if scene.prev_positions is not None:
        src += (scene.prev_positions,)

    def build():    # a miss: its span's count is the misses'
        with profile_scope("geometry.attr_table"):
            return attr_table(src[:3] + src[4:],
                              [scene.face_normals(), src[3]])

    if any(t.is_inference() for t in src):     # they keep no version
        return build()
    key = tuple((id(t), t._version) for t in src)
    hit = _ATTR_TABLES.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], src)):
        if len(src) == 5:
            for k in [k for k, v in _ATTR_TABLES.items() if len(v[0]) == 5]:
                del _ATTR_TABLES[k]
        if len(_ATTR_TABLES) >= _ATTR_TABLES_MAX:
            _ATTR_TABLES.clear()
        hit = _ATTR_TABLES[key] = (src, build())
    return hit[1]


def pattern_jittered_scene(scene, pattern, sample_count, frame_index: int,
                           width: int, height: int):
    """The scene with this frame's camera jitter from the pass's sample
    pattern (GBufferBase::updateSamplePattern; Camera::setJitter scales by
    1 / resolution): offset frame_index % N of the pattern, divided on the
    host in float32 as the reference package divides it. Center leaves
    the scene as it is."""
    if pattern in ("Center", None, ""):
        return scene
    offs = sample_pattern_offsets(pattern, int(sample_count))
    o = offs[int(frame_index) % offs.shape[0]]
    cam = scene.camera

    def f32(x):
        return torch.as_tensor(np.float32(x), device=cam.pos_w.device)

    return scene.with_camera(dataclasses.replace(
        cam, jitter_x=f32(o[0] / np.float32(width)),
        jitter_y=f32(o[1] / np.float32(height))))


def pixel_centres(n: int, device):
    """(arange(n) + 0.5) / n in float32, an IEEE division on every device
    (a CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead: ROADMAP hazard c)."""
    return true_div(torch.arange(n, dtype=torch.float32, device=device)
                    + 0.5, n)


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
    fetched = fetch_vertex_attributes(tid, bary,
                                      table=attribute_table(scene))
    pos_w, norm_w, tex_c = fetched[:3]
    face_n, mtl = fetched[-2:]
    norm_w = torch.where(hit[..., None], normalize(norm_w), 0.0)
    face_n = torch.where(hit[..., None], face_n, 0.0)
    mtl = torch.where(hit, mtl, -1)

    # motion vectors: texC + mvec = previous-frame uv, from the no-jitter
    # matrices; animated geometry projects last frame's position of the
    # surface point, static geometry this frame's
    h, w = tid.shape
    prev_pos_w = pos_w if scene.prev_positions is None else \
        torch.where(hit[..., None], fetched[3], pos_w)
    prev_clip = transform_point(cam.prev_view_proj_no_jitter, prev_pos_w)
    prev_w = torch.where(prev_clip[..., 3] == 0.0, 1.0, prev_clip[..., 3])
    prev_uv = torch.stack([prev_clip[..., 0] / prev_w * 0.5 + 0.5,
                           0.5 - prev_clip[..., 1] / prev_w * 0.5], -1)
    gy, gx = torch.meshgrid(pixel_centres(h, tid.device),
                            pixel_centres(w, tid.device), indexing="ij")
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
    """reference Source/RenderPasses/GBuffer/GBufferRaster.cpp, with the
    reference package's keys and their meaning there:

    * samplePattern: Center, DirectX, Halton or Stratified; sampleCount
      is the Halton and Stratified patterns' length
      (pattern_jittered_scene);
    * useAlphaTest, adjustShadingNormals, forceCullMode: accepted; the
      reference package's raster honours neither value either (its
      G-buffer raster never alpha-tests and never adjusts normals), so both
      values give the reference's result;
    * outputSize: only "Default" (others raise);
    * maxPerTile: accepted and without effect: the CUDA raster keeps no
      per-tile list cap, so no triangle is ever dropped (ROADMAP hazard f).
    """

    SCHEMA = dict(outputSize="Default", samplePattern="Center", sampleCount=8,
                  useAlphaTest=True, adjustShadingNormals=True,
                  forceCullMode=False, cull="Back", maxPerTile=256)
    CHANNELS = ("depth", "posW", "normW", "faceNormalW", "texC", "mvec",
                "mtlData", "tri_id", "bary")

    def reflect(self, ctx):
        r = PassReflection()
        for c in self.CHANNELS:
            r.add_output(c)
        return r

    def execute(self, ctx, inputs, state=None):
        if self.cfg["outputSize"] != "Default":
            raise NotImplementedError(
                "GBufferRaster: only outputSize='Default' is ported")
        scene = pattern_jittered_scene(ctx.scene, self.cfg["samplePattern"],
                                       self.cfg["sampleCount"],
                                       ctx.frame_index, ctx.width,
                                       ctx.height)
        return raster_gbuffer(scene, ctx.width, ctx.height,
                              cull=self.cfg["cull"].lower()), None


@register_pass("DepthPass")
class DepthPass(RenderPass):
    """Depth pre-pass (reference Source/RenderPasses/DepthPass/): the NDC
    depth of one visibility raster (K1 with no floor). useAlphaTest and
    maxPerTile are accepted and change nothing, as in the reference
    package's raster."""

    SCHEMA = dict(depthFormat="D32Float", useAlphaTest=True, cullMode="Back",
                  maxPerTile=256)

    def reflect(self, ctx):
        return PassReflection().add_output("depth")

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        vis = rasterize(cam.view_proj_no_jitter, ctx.scene.positions,
                        width=ctx.width, height=ctx.height,
                        jitter_x=cam.jitter_x, jitter_y=cam.jitter_y,
                        cull=self.cfg["cullMode"].lower())
        return {"depth": vis["depth"]}, None
