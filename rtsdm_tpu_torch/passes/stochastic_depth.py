"""Stochastic depth-map passes (counterpart of
rtsdm_tpu/passes/stochastic_depth.py).

StochasticDepthMapRT — the paper's k-layer stochastic depth map from ONE
ray per SD texel with reservoir insertion (reference StochasticDepthMapRT:
rayGen .rt.slang:63-105, ray setup Common.slangh:65-92, insertion
Common.slangh:102-254). The trace is K7 (resident) or K5 (streamed),
ops/rt_cuda.py.

StochasticDepthMap — the raster baseline (reference StochasticDepthMap/
StochasticDepth.ps.slang): a k-slot raster over the SD grid in which each
fragment behind the first depth layer writes into a hash-chosen
stratified subset of the slots. The raster is K9
(ops/raster.raster_stochastic_slots), at every triangle count; the host's
setup and finish around it are the span sd_raster.
"""
from __future__ import annotations

import torch

from ..core.profiler import profile_scope
from ..ops import rt_cuda as rt
from ..ops.raster import (raster_stochastic_slots, stochastic_depths,
                          stochastic_planes)
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.device import device_constant
from ..utils.math import dot3
from ..utils.sampling import jitter_grid

_IMPL_NAMES = {0: "default", 1: "coverage", 2: "reservoir", 3: "kbuffer"}
# pallasStream="auto" keeps the trace resident (K7) up to this many
# triangles (rtsdm_tpu/passes/stochastic_depth.py:150-151)
RESIDENT_MAX_TRIANGLES = 65536


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
    from the rayMin/rayMax inputs. The trace takes the reference's Pallas
    tiers: pallasStream 'auto' streams (K5) above RESIDENT_MAX_TRIANGLES
    and stays resident (K7) otherwise; True and False force one. Every
    Implementation and MaxCount are ported; coverage ignores MaxCount.
    usePallas=False (the reference's XLA tier), coverage with SampleCount
    above rt.COVERAGE_MAX_K, StoreNormals and a depthFormat raise
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
        if impl not in rt.MODES:
            raise ValueError(f"StochasticDepthMapRT: unknown Implementation "
                             f"{impl!r}")
        if not cfg["usePallas"]:
            raise NotImplementedError(
                "StochasticDepthMapRT: usePallas=False selects the "
                "reference's XLA tier (rtsdm_tpu/ops/rt.py:sd_trace), which "
                "is not ported (ROADMAP queue 1, item 9)")
        if impl == "coverage" and int(cfg["SampleCount"]) > rt.COVERAGE_MAX_K:
            raise NotImplementedError(
                f"StochasticDepthMapRT: coverage with SampleCount > "
                f"{rt.COVERAGE_MAX_K} takes the reference's XLA tier, which "
                "is not ported (ROADMAP queue 1, item 9)")
        for key, default in (("StoreNormals", False), ("depthFormat", None)):
            if cfg[key] != default:
                raise NotImplementedError(
                    f"StochasticDepthMapRT: {key}={cfg[key]!r} is not ported "
                    "(ROADMAP queue 1, item 9)")
        # 0 = uncapped; coverage ignores MaxCount (Common.slangh:117)
        max_count = 0 if impl == "coverage" else int(cfg["MaxCount"] or 0)
        return impl, max_count

    def streams(self, scene) -> bool:
        """Whether the trace takes the streamed tier (K5) for `scene`."""
        stream = self.cfg["pallasStream"]
        if stream == "auto":
            return scene.num_triangles > RESIDENT_MAX_TRIANGLES
        return bool(stream)

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

        streams = self.streams(ctx.scene)
        trace = dict(num_samples=k, cull_back=self.cfg["CullMode"] == "Back",
                     mode=impl, max_count=max_count,
                     alpha=float(self.cfg["Alpha"]))
        with profile_scope("sd_rays"):
            # one ray per texel (Common.slangh:65-92)
            py, px = torch.meshgrid(torch.arange(sd_h, device=dev),
                                    torch.arange(sd_w, device=dev),
                                    indexing="ij")
            signed = torch.stack([px - guard, py - guard], -1) \
                .to(torch.float32)
            jit = jitter_grid(sd_h, sd_w, bool(self.cfg["Jitter"]),
                              device=dev)
            origin, dirs = cam.compute_ray_pinhole(signed, (dim_w, dim_h),
                                                   jitter=jit)
            cos_w = dot3(dirs, cam.camera_w / torch.sqrt(
                dot3(cam.camera_w, cam.camera_w)))
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
                frame_uv = (signed + 0.5) / device_constant(
                    (dim_w, dim_h), torch.float32, dev)
                depth = torch.where(inside, _bilinear_sample(
                    lin_z, torch.clamp(frame_uv, 0.0, 1.0)), 0.0)
            tmin = depth * inv_cos + 0.1 * cam.near_z  # behind the first hit
            if self.cfg["RayInterval"]:
                # a raw 0 means "not written" (Common.slangh:80-89); the
                # FLT_MAX rayMin clear kills unrequested texels through the
                # max
                tmin = torch.where(ray_min != 0.0,
                                   torch.maximum(ray_min, tmin), tmin)
                tmax = torch.where(ray_max != 0.0,
                                   torch.minimum(ray_max, tmax), tmax)
            if streams:

                def tf(x2d, fill=0.0):  # 8x32-tile ray order
                    return rt.tile_flatten(rt.pad_tile(x2d, fill)[0])

                rays = (tf(dirs), tf(tmin), tf(tmax, -1.0), tf(cos_w))
                trace.update(rx=tf(signed[..., 0]), ry=tf(signed[..., 1]))
            else:
                rays = (dirs.reshape(-1, 3), tmin.reshape(-1),
                        tmax.reshape(-1), cos_w.reshape(-1))
                trace.update(grid=(sd_h, sd_w))

        with profile_scope("geometry.sd_pack"):
            tri_packed, aabb = rt.prep_triangles_packed(
                ctx.scene, bool(self.cfg["AlphaTest"]), origin)
            if streams:
                scr = rt.chunk_screen_rows(aabb, origin, cam.camera_u,
                                           cam.camera_v, cam.camera_w, dim_w,
                                           dim_h)
                aabb = torch.cat([aabb[:6], scr], 0)
        if streams:
            ph = sd_h + (-sd_h) % rt.TILE_RH
            pw = sd_w + (-sd_w) % rt.TILE_RW
            packed = rt.sd_trace_stream(tri_packed, aabb, origin, *rays,
                                        cam.near_z, cam.far_z, **trace)
            packed = rt.tile_unflatten(packed, ph, pw)[:sd_h, :sd_w]
        else:
            packed = rt.sd_trace_resident(
                tri_packed, aabb, origin, *rays, cam.near_z, cam.far_z,
                **trace).reshape(sd_h, sd_w, k)
        # the rays in tile order (217 MB at config 3) go as the trace
        # returns, before the decode makes its temporaries
        del rays, trace
        depths = rt.decode_packed(packed, cam.near_z, cam.far_z,
                                  bool(self.cfg["normalize"]), mode=impl)
        ctx.debug_print("sdrt.stochasticDepth", depths)
        ctx.debug_print("sdrt.rayMin", ray_min)
        ctx.debug_print("sdrt.rayMax", ray_max)
        return {"stochasticDepth": depths}, None


def _uv_grid(h: int, w: int, *, device):
    """[h, w, 2] texel-centre uv of an h x w grid."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


@register_pass("StochasticDepthMap")
class StochasticDepthMap(RenderPass):
    """Output 'stochasticDepth': [sdH, sdW, SampleCount] view depths,
    linearized to [0, 1] with `linearize` (else linear, far where empty).
    The SD grid is rayMax's shape, else the render size over `divisor`.
    maxPerTile is accepted and without effect: K9 keeps no per-tile cap.
    Implementation and AlphaTest are accepted and without effect, as in
    the reference package's raster."""

    SCHEMA = dict(SampleCount=4, CullMode="Back", AlphaTest=True,
                  Implementation="default", Alpha=0.375, RayInterval=True,
                  linearize=True, depthFormat=None, maxPerTile=256,
                  divisor=1)

    def reflect(self, ctx):
        return (PassReflection().add_input("depthMap")
                .add_input("rayMin", optional=True)
                .add_input("rayMax", optional=True)
                .add_output("stochasticDepth"))

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        ray_max = inputs.get("rayMax")
        if ray_max is not None:
            sd_h, sd_w = ray_max.shape
        else:
            d = int(self.cfg["divisor"])
            sd_h, sd_w = -(-ctx.height // d), -(-ctx.width // d)
        k = int(self.cfg["SampleCount"])

        interval = bool(self.cfg["RayInterval"])
        # the host's setup and finish of the raster: beside the binning
        # (geometry.raster_bins) and K9's wrapper, never around them
        with profile_scope("sd_raster"):
            lin_full = cam.linearize_depth(inputs["depthMap"])
            div0 = lin_full.shape[1] // max(sd_w, 1)
            if div0 in (1, 2, 4) and lin_full.shape[1] == sd_w * div0 \
                    and lin_full.shape[0] == sd_h * div0:
                first_lin = _downsample_linear(lin_full, div0, sd_w, sd_h)
            else:
                first_lin = _bilinear_sample(
                    lin_full, _uv_grid(sd_h, sd_w, device=lin_full.device))
            planes = stochastic_planes(
                sd_w, sd_h, first_lin,
                inputs.get("rayMin") if interval else None,
                ray_max if interval else None, lin_full.device)
        slots = raster_stochastic_slots(
            cam.view_proj_no_jitter, ctx.scene.positions, planes, width=sd_w,
            height=sd_h, k=k, alpha=float(self.cfg["Alpha"]),
            cull=self.cfg["CullMode"].lower())
        with profile_scope("sd_raster"):
            depths = stochastic_depths(slots, sd_w, sd_h, cam.far_z)
            if self.cfg["linearize"]:
                depths = torch.clamp((depths - cam.near_z)
                                     / (cam.far_z - cam.near_z), 0.0, 1.0)
        return {"stochasticDepth": depths}, None
