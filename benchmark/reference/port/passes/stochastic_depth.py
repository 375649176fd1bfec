"""The stochastic depth-map pass of the benchmark's graphs (counterpart
of rtsdm_tpu/passes/stochastic_depth.py).

StochasticDepthMapRT — the paper's k-layer stochastic depth map from ONE
ray per SD texel with reservoir insertion (reference StochasticDepthMapRT:
rayGen .rt.slang:63-105, ray setup Common.slangh:65-92, insertion
Common.slangh:102-254). The port traces with K7 (resident) or K5
(streamed); this copy traces with ops/ref_sd_trace.py, their function by
a cull of its own. The port's raster baseline (StochasticDepthMap, K9) is
not in this copy.
"""
from __future__ import annotations

import torch

from ..ops import ref_sd_trace
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
    from the rayMin/rayMax inputs. Only the default Implementation
    without MaxCount is in this copy (ops/ref_sd_trace.py raises for the
    others); usePallas=False, StoreNormals and a depthFormat raise
    NotImplementedError at render time. `linearize` and `chunk` are taken
    and, as in the reference, change nothing on the ported tiers."""

    SCHEMA = dict(SampleCount=4, CullMode="Back", AlphaTest=True,
                  Implementation="default", Alpha=0.2, RayInterval=True,
                  normalize=True, StoreNormals=False, Jitter=True,
                  GuardBand=0, MaxCount=0, linearize=False, depthFormat=None,
                  chunk=128, usePallas=True, pallasStream="auto")

    def reflect(self, ctx):
        return (PassReflection().add_input("linearZ").add_input("rayMin")
                .add_input("rayMax").add_output("stochasticDepth"))

    def _insertion(self):
        """(mode, max_count) of the configuration; raises for what the port
        does not run."""
        cfg = self.cfg
        impl = _IMPL_NAMES.get(cfg["Implementation"], cfg["Implementation"])
        impl = "default" if impl == "reservoir" else impl
        if impl != "default" or int(cfg["MaxCount"] or 0):
            raise NotImplementedError(
                f"StochasticDepthMapRT: Implementation {impl!r} with MaxCount "
                f"{cfg['MaxCount']!r} is not in this copy")
        if not cfg["usePallas"]:
            raise NotImplementedError(
                "StochasticDepthMapRT: usePallas=False selects the "
                "reference's XLA tier, which is not ported")
        for key, default in (("StoreNormals", False), ("depthFormat", None)):
            if cfg[key] != default:
                raise NotImplementedError(
                    f"StochasticDepthMapRT: {key}={cfg[key]!r} is not ported")
        return impl, 0

    def execute(self, ctx, inputs, state=None):
        impl, max_count = self._insertion()
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

        tri_packed, _ = rt.prep_triangles_packed(
            ctx.scene, bool(self.cfg["AlphaTest"]), origin)
        # K5's and K7's function by the reference's own cull
        # (ops/ref_sd_trace.py), not the port's chunk lists
        packed = ref_sd_trace.sd_trace(
            ctx.scene.positions, tri_packed, origin, dirs.reshape(-1, 3),
            tmin.reshape(-1), tmax.reshape(-1), cos_w.reshape(-1),
            cam.near_z, cam.far_z, num_samples=k,
            cull_back=self.cfg["CullMode"] == "Back", mode=impl,
            max_count=max_count).reshape(sd_h, sd_w, k)
        depths = rt.decode_packed(packed, cam.near_z, cam.far_z,
                                  bool(self.cfg["normalize"]), mode=impl)
        ctx.debug_print("sdrt.stochasticDepth", depths)
        ctx.debug_print("sdrt.rayMin", ray_min)
        ctx.debug_print("sdrt.rayMax", ray_max)
        return {"stochasticDepth": depths}, None

