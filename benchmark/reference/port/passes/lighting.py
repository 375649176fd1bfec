"""Shading passes: EnvMapPass, RayShadow, ForwardLighting (counterpart of rtsdm_tpu/passes/lighting.py; reference EnvMapPass.ps.slang,
ForwardLighting.3d.slang, RayShadow.ps.slang).

ForwardLighting re-derives the G-buffer with raster_gbuffer, as the
reference graph does (it re-rasters the scene). Under jit the JAX package's
XLA merges that call with GBufferRaster's identical one; PyTorch runs
eagerly, so here the raster and the attribute fetch run twice per frame.
"""
from __future__ import annotations

import torch

from ..ops import brdf
from ..ops import rt_cuda as RT
from ..ops.materials import fetch_shading_materials
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..scene.scene import LIGHT_DIRECTIONAL
from ..scene.textures import sample_env, sample_pages
from ..utils.math import dot3, normalize, saturate
from .gbuffer import raster_gbuffer


@register_pass("EnvMapPass")
class EnvMapPass(RenderPass):
    """Environment radiance along the camera ray of every pixel
    (EnvMapPass.ps.slang); a fill with the constant radiance when the scene
    has no env map."""

    SCHEMA = dict()

    def reflect(self, ctx):
        return PassReflection().add_input("depth").add_output("color")

    def execute(self, ctx, inputs, state=None):
        h, w = inputs["depth"].shape
        scene = ctx.scene
        if scene.env_map is None:
            return {"color": scene.env_radiance.expand(h, w, 3)}, None
        dev = inputs["depth"].device
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        _, dirs = scene.camera.compute_ray_pinhole(torch.stack([xs, ys], -1),
                                                   (w, h))
        return {"color": sample_env(scene.env_map, dirs)
                * scene.env_radiance}, None


@register_pass("RayShadow")
class RayShadow(RenderPass):
    """Per-light shadow visibility (RayShadow.ps.slang:131-186): one ray from
    each shaded point toward each analytic light (at most maxLights); any
    hit in (tmin, tmax) occludes. The rays go to the any-hit kernel (K8) in
    8x32-tile order, as the reference's accelerator path sends them."""

    SCHEMA = dict(pointLightClip=0.1, maxLights=2)

    def reflect(self, ctx):
        return (PassReflection().add_input("posW").add_input("normalW")
                .add_output("visibility"))

    def execute(self, ctx, inputs, state=None):
        scene = ctx.scene
        pos_w = inputs["posW"]
        valid = pos_w[..., 3] > 0.0
        p = pos_w[..., :3]
        n = inputs["normalW"][..., :3]
        h, w = valid.shape
        n_lights = min(int(scene.num_lights), int(self.cfg["maxLights"]))

        # scene AABB for shadow-segment clipping: a directional-light ray
        # otherwise carries tmax = far_z, its tile's segment box spans the
        # frustum and the tile walks the whole scene
        pts = scene.positions.reshape(-1, 3)
        smin, smax = pts.amin(0), pts.amax(0)

        vis_slices = []
        for li in range(n_lights):
            is_dir = scene.light_type[li] == LIGHT_DIRECTIONAL
            to_light = torch.where(is_dir, -scene.light_dir[li],
                                   normalize(scene.light_pos[li] - p))
            rel = scene.light_pos[li] - p
            dist = torch.sqrt(dot3(rel, rel))
            tmax = torch.where(is_dir, scene.camera.far_z,
                               dist - float(self.cfg["pointLightClip"]))
            # slab-clip to the scene AABB exit
            inv = 1.0 / torch.where(torch.abs(to_light) < 1e-8, 1e-8,
                                    to_light)
            ta = (smin - p) * inv
            tb = (smax - p) * inv
            t_exit = torch.maximum(ta, tb).amin(-1)
            tmax = torch.minimum(tmax, torch.clamp(t_exit, min=0.0) + 1e-3)
            # dead rays (background, light-backfacing surfaces: their
            # visibility is fixed whatever the trace finds) must not widen
            # the tiles' segment boxes: tmax = -1
            facing = dot3(to_light, n) > 0.0
            tmax = torch.where(valid & facing, tmax, -1.0)
            tmin = scene.camera.near_z * 0.1
            pt, _ = RT.pad_tile(p)
            dt, _ = RT.pad_tile(to_light)
            xt, _ = RT.pad_tile(tmax, fill=-1.0)
            ph, pw = pt.shape[:2]
            hit_t = RT.any_hit(scene, RT.tile_flatten(pt),
                               RT.tile_flatten(dt), tmin.expand(ph * pw),
                               RT.tile_flatten(xt))
            hit = RT.tile_unflatten(hit_t, ph, pw)[:h, :w]
            vis = torch.where(hit, 0.0, 1.0)
            vis = torch.where(facing, vis, 0.0)   # RayShadow.ps.slang:178
            vis = torch.where(valid, vis, 1.0)
            vis_slices.append(vis)
        if not vis_slices:
            vis_slices = [torch.ones((h, w), device=p.device)]
        return {"visibility": torch.stack(vis_slices)}, None


def shading_inputs(scene, g):
    """Per-pixel shading fields of the lighting passes (StandardMaterial
    metallic workflow resolved from the G-buffer)."""
    hit = g["posW"][..., 3] > 0.0
    mat = fetch_shading_materials(scene, torch.clamp(g["mtlData"], min=0))
    albedo = mat["base_color"]
    if scene.tex_pages is not None and g.get("texC") is not None:
        albedo = albedo * sample_pages(scene.tex_pages, mat["tex"],
                                       g["texC"])
    n = g["normW"][..., :3]
    p = g["posW"][..., :3]
    wo = normalize(scene.camera.pos_w - p)
    diff_albedo, f0 = brdf.metallic_albedos(albedo, mat["metallic"],
                                            mat["ior"])
    return dict(hit=hit, n=n, p=p, wo=wo, diff_albedo=diff_albedo, f0=f0,
                rough=mat["roughness"], emissive=mat["emissive"])


def _shade(scene, g, visibility, env_color, ambient_intensity: float,
           env_intensity: float, light_intensity: float,
           env_map_mirror: bool = False):
    """Shading core of Forward/Deferred lighting (ForwardLighting.3d.slang:
    34-90): emission + ambient * diffuse albedo + env diffuse/specular +
    every light's shadowed BSDF term."""
    si = shading_inputs(scene, g)
    hit = si["hit"]
    n, p, wo = si["n"], si["p"], si["wo"]
    diff_albedo, f0, rough = si["diff_albedo"], si["f0"], si["rough"]

    color = si["emissive"] + ambient_intensity * diff_albedo
    # env terms (ForwardLighting.3d.slang:53-63): diffuse along the normal,
    # specular along the mirror direction capped by roughnessToIntensity
    if scene.env_map is not None:
        r_dir = normalize(2.0 * dot3(wo, n)[..., None] * n - wo)
        env_n = sample_env(scene.env_map, n) * scene.env_radiance
        env_r = sample_env(scene.env_map, r_dir) * scene.env_radiance
    else:
        env_n = env_r = scene.env_radiance.expand(color.shape)
    color = color + env_intensity * diff_albedo * torch.clamp(env_n, max=1.0)
    spec_cap = saturate(1.0 / (rough + 0.1))[..., None]
    color = color + env_intensity * f0 * torch.minimum(env_r, spec_cap)
    if env_map_mirror:
        fr = brdf.fresnel_schlick(torch.clamp(dot3(wo, n), min=0.0),
                                  0.3)[..., None]
        color = color + torch.where((rough < 0.08)[..., None], fr * env_r,
                                    0.0)

    for li in range(int(scene.num_lights)):
        is_dir = scene.light_type[li] == LIGHT_DIRECTIONAL
        to_light = torch.where(is_dir, -scene.light_dir[li],
                               normalize(scene.light_pos[li] - p))
        rel = scene.light_pos[li] - p
        li_rad = torch.where(
            is_dir, scene.light_intensity[li],
            scene.light_intensity[li]
            / torch.clamp(dot3(rel, rel), min=1e-4)[..., None])
        shadow = (visibility[li][..., None]
                  if visibility is not None and li < visibility.shape[0]
                  else 1.0)
        f_cos = brdf.eval_lobes(diff_albedo, f0, rough, n, wo, to_light)
        color = color + shadow * f_cos * li_rad * light_intensity
    return torch.where(hit[..., None], color, env_color)


@register_pass("ForwardLighting")
class ForwardLighting(RenderPass):
    """maxPerTile is accepted and has no effect: the CUDA raster keeps no
    per-tile list cap (ROADMAP hazard f)."""

    SCHEMA = dict(envMapIntensity=0.25, ambientIntensity=0.25,
                  lightIntensity=0.5, envMapMirror=False, maxPerTile=256)

    def reflect(self, ctx):
        return (PassReflection().add_input("depth").add_input("color")
                .add_input("visibilityBuffer", optional=True)
                .add_output("color"))

    def execute(self, ctx, inputs, state=None):
        g = raster_gbuffer(ctx.scene, ctx.width, ctx.height)
        color = _shade(ctx.scene, g, inputs.get("visibilityBuffer"),
                       inputs["color"],
                       float(self.cfg["ambientIntensity"]),
                       float(self.cfg["envMapIntensity"]),
                       float(self.cfg["lightIntensity"]),
                       env_map_mirror=bool(self.cfg["envMapMirror"]))
        return {"color": color}, None
