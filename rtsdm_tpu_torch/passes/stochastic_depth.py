"""StochasticDepthMapRT — the paper's k-layer stochastic depth map from ONE
ray per SD texel with reservoir insertion (counterpart of
rtsdm_tpu/passes/stochastic_depth.py; reference StochasticDepthMapRT:
rayGen .rt.slang:63-105, ray setup Common.slangh:65-92, insertion
Common.slangh:102-254). The trace is K5 (ops/rt_cuda.py).
"""
from __future__ import annotations

import torch

from ..ops import rt_cuda as rt
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import dot3
from ..utils.sampling import jitter_grid

_IMPL_NAMES = {0: "default", 1: "coverage", 2: "reservoir", 3: "kbuffer"}


def _bilinear_sample(tex, uv):
    """Linear-filtered sample of [H,W] at uv [..., 2]."""
    h, w = tex.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    a = tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx
    b = tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx
    return a * (1 - fy) + b * fy


def _downsample_linear(tex, divisor: int, dim_w: int, dim_h: int):
    """_bilinear_sample on the regular SD grid for divisor in {1, 2, 4}:
    SD texel s samples full-res position divisor*s + divisor/2, the average
    of two strided rows and columns."""
    if divisor == 1:
        return tex[:dim_h, :dim_w]
    o = divisor // 2
    t = tex[:dim_h * divisor, :dim_w * divisor]
    r = (t[o - 1::divisor][:dim_h] + t[o::divisor][:dim_h]) * 0.5
    return (r[:, o - 1::divisor][:, :dim_w] + r[:, o::divisor][:, :dim_w]) \
        * 0.5


@register_pass("StochasticDepthMapRT")
class StochasticDepthMapRT(RenderPass):
    """Output 'stochasticDepth': [sdH, sdW, SampleCount] normalized view
    depths, 1.0 where empty; the SD resolution (with guard band) is taken
    from the rayMin/rayMax inputs. Implementation 'default'/'reservoir' and
    'kbuffer' are ported; 'coverage' and MaxCount != 0 raise (ROADMAP queue
    1, item 7: MaxCount depends on traversal order)."""

    SCHEMA = dict(SampleCount=4, CullMode="Back", AlphaTest=True,
                  Implementation="default", RayInterval=True, normalize=True,
                  Jitter=True, GuardBand=0, MaxCount=0)

    def reflect(self, ctx):
        return (PassReflection().add_input("linearZ").add_input("rayMin")
                .add_input("rayMax").add_output("stochasticDepth"))

    def _impl(self):
        impl = self.cfg["Implementation"]
        impl = _IMPL_NAMES.get(impl, impl)
        impl = "default" if impl == "reservoir" else impl
        if impl not in rt.MODES:
            raise NotImplementedError(
                f"StochasticDepthMapRT: Implementation '{impl}' is not ported "
                "(ROADMAP queue 1, item 7)")
        if self.cfg["MaxCount"]:
            raise NotImplementedError(
                "StochasticDepthMapRT: MaxCount != 0 is not ported (ROADMAP "
                "queue 1, item 7; it depends on traversal order)")
        return impl

    def execute(self, ctx, inputs, state=None):
        impl = self._impl()
        cam = ctx.scene.camera
        ray_min, ray_max = inputs["rayMin"], inputs["rayMax"]
        lin_z = inputs["linearZ"]
        sd_h, sd_w = ray_max.shape
        guard = int(self.cfg["GuardBand"])
        dim_w, dim_h = sd_w - 2 * guard, sd_h - 2 * guard
        k = int(self.cfg["SampleCount"])
        dev = ray_max.device

        # one ray per texel (Common.slangh:65-92)
        py, px = torch.meshgrid(torch.arange(sd_h, device=dev),
                                torch.arange(sd_w, device=dev), indexing="ij")
        signed = torch.stack([px - guard, py - guard], -1).to(torch.float32)
        jit = jitter_grid(sd_h, sd_w, bool(self.cfg["Jitter"]), device=dev)
        origin, dirs = cam.compute_ray_pinhole(signed, (dim_w, dim_h),
                                               jitter=jit)
        cos_w = dot3(dirs, cam.camera_w / torch.sqrt(dot3(cam.camera_w,
                                                          cam.camera_w)))
        inv_cos = 1.0 / cos_w
        tmax = cam.far_z * inv_cos

        divisor = lin_z.shape[1] // max(dim_w, 1)
        if divisor in (1, 2, 4) and lin_z.shape[1] == dim_w * divisor \
                and lin_z.shape[0] == dim_h * divisor:
            interior = _downsample_linear(lin_z, divisor, dim_w, dim_h)
            depth = torch.nn.functional.pad(
                interior, (guard, sd_w - dim_w - guard,
                           guard, sd_h - dim_h - guard))
        else:
            inside = ((signed[..., 0] >= 0) & (signed[..., 0] < dim_w)
                      & (signed[..., 1] >= 0) & (signed[..., 1] < dim_h))
            frame_uv = (signed + 0.5) / torch.tensor(
                [dim_w, dim_h], dtype=torch.float32, device=dev)
            depth = torch.where(inside, _bilinear_sample(
                lin_z, torch.clamp(frame_uv, 0.0, 1.0)), 0.0)
        tmin = depth * inv_cos + 0.1 * cam.near_z  # behind the first hit
        if self.cfg["RayInterval"]:
            # a raw 0 means "not written" (Common.slangh:80-89); the FLT_MAX
            # rayMin clear kills unrequested texels through the max
            tmin = torch.where(ray_min != 0.0, torch.maximum(ray_min, tmin),
                               tmin)
            tmax = torch.where(ray_max != 0.0, torch.minimum(ray_max, tmax),
                               tmax)

        tri_packed, aabb = rt.prep_triangles_packed(
            ctx.scene, bool(self.cfg["AlphaTest"]), origin)
        scr = rt.chunk_screen_rows(aabb, origin, cam.camera_u, cam.camera_v,
                                   cam.camera_w, dim_w, dim_h)
        aabb = torch.cat([aabb[:6], scr], 0)

        def tf(x2d, fill=0.0):  # 8x32-tile ray order
            return rt.tile_flatten(rt.pad_tile(x2d, fill)[0])

        ph = sd_h + (-sd_h) % rt.TILE_RH
        pw = sd_w + (-sd_w) % rt.TILE_RW
        packed = rt.sd_trace_stream(
            tri_packed, aabb, origin, tf(dirs), tf(tmin), tf(tmax, -1.0),
            tf(cos_w), cam.near_z, cam.far_z, num_samples=k,
            cull_back=self.cfg["CullMode"] == "Back", mode=impl,
            rx=tf(signed[..., 0]), ry=tf(signed[..., 1]))
        packed = rt.tile_unflatten(packed, ph, pw)[:sd_h, :sd_w]
        depths = rt.decode_packed(packed, cam.near_z, cam.far_z,
                                  bool(self.cfg["normalize"]), mode=impl)
        return {"stochasticDepth": depths}, None
