"""SVAO — Stenciled Volumetric Ambient Occlusion, the paper's main pass
(counterpart of rtsdm_tpu/passes/svao.py; reference SVAO.cpp:192-456:
phase 1 -> nested SD graph -> phase 2).

Ported configuration: samplingMode 'shift', primaryDepthMode 'SingleDepth',
secondaryDepthMode 'StochasticDepth' with stochasticDepthImpl 'Ray', kernel
'VAO'. Every other mode raises NotImplementedError until its ROADMAP item
(queue 1, item 12) ports it.
"""
from __future__ import annotations

import math

import torch

from ..ops import ao as A
from ..rendergraph.graph import RenderGraph
from ..rendergraph.render_pass import (PassReflection, RenderContext,
                                       RenderPass, register_pass)
from ..utils.math import decode_normal_2x16, normalize, transform_vector
from . import stochastic_depth  # noqa: F401  (registers the nested SD pass)

DEPTH_MODE_SINGLE = "SingleDepth"
DEPTH_MODE_STOCHASTIC = "StochasticDepth"

_SUPPORTED = dict(samplingMode="shift", primaryDepthMode=DEPTH_MODE_SINGLE,
                  secondaryDepthMode=DEPTH_MODE_STOCHASTIC,
                  stochasticDepthImpl="Ray", kernel="VAO", dualAO=False)


def _normals_to_view(ctx, normals):
    """Packed 2x16 octahedral view-space normals (CompressNormals output,
    int32) or world-space float normals -> unit view-space normals."""
    if normals.dtype == torch.int32:
        return decode_normal_2x16(normals)
    n = normalize(normals[..., :3])
    return normalize(transform_vector(ctx.scene.camera.view_mat, n))


def _dilate(a, radius_steps: int, op, fill: float):
    """Separable doubling dilation: after shifts 1, 2, .., 2^(m-1) the
    window radius is 2^m - 1."""
    for axis in (0, 1):
        shift = 1
        for _ in range(radius_steps):
            lo = torch.full_like(a, fill)
            hi = torch.full_like(a, fill)
            if axis == 0:
                lo[shift:] = a[:-shift]
                hi[:-shift] = a[shift:]
            else:
                lo[:, shift:] = a[:, :-shift]
                hi[:, :-shift] = a[:, shift:]
            a = op(op(a, lo), hi)
            shift *= 2
    return a


def _intervals_to_sd_grid(cfg, radius_px, pix_rmin, pix_rmax, sd_h: int,
                          sd_w: int):
    """Per-pixel ray-interval bounds -> SD-grid rayMin/rayMax. The
    reference scatters each sample's bounds into the SD texel it lands in
    with atomics (SVAORaster.ps.slang:87-95); this conservative equivalent
    block-reduces pixels onto their own texel and dilates by the sampling
    radius binned into power-of-two levels. Wider intervals are correct (a
    superset of hits reaches the reservoir)."""
    h, w = pix_rmin.shape
    g = cfg.sd_guard
    core_w, core_h = sd_w - 2 * g, sd_h - 2 * g
    div = max(1, round(w / core_w))
    r_tex = torch.clamp(radius_px / div, 1.0,
                        max(cfg.ss_max_radius / div, 1.0))
    max_level = max(int(math.ceil(math.log2(max(cfg.ss_max_radius / div,
                                                1.0)))), 0)
    pad = (0, core_w * div - w, 0, core_h * div - h)
    dev = pix_rmin.device
    rmin_full = torch.full((sd_h, sd_w), A.FLT_MAX, device=dev)
    rmax_full = torch.zeros((sd_h, sd_w), device=dev)
    for level in range(max_level + 1):
        lo = 0.0 if level == 0 else float(2 ** (level - 1))
        sel = (r_tex > lo) & (r_tex <= float(2 ** level))
        lv_min = torch.nn.functional.pad(
            torch.where(sel, pix_rmin, A.FLT_MAX), pad, value=A.FLT_MAX)
        lv_max = torch.nn.functional.pad(torch.where(sel, pix_rmax, 0.0), pad)
        gmin = torch.full((sd_h, sd_w), A.FLT_MAX, device=dev)
        gmax = torch.zeros((sd_h, sd_w), device=dev)
        gmin[g:g + core_h, g:g + core_w] = \
            lv_min.reshape(core_h, div, core_w, div).amin((1, 3))
        gmax[g:g + core_h, g:g + core_w] = \
            lv_max.reshape(core_h, div, core_w, div).amax((1, 3))
        # dilate by the level radius (+1 step for the block-alignment slack)
        rmin_full = torch.minimum(
            rmin_full, _dilate(gmin, level + 1, torch.minimum, A.FLT_MAX))
        rmax_full = torch.maximum(
            rmax_full, _dilate(gmax, level + 1, torch.maximum, 0.0))
    return rmin_full, rmax_full


@register_pass("SVAO")
class SVAO(RenderPass):
    SCHEMA = dict(
        radius=0.5, primaryDepthMode=DEPTH_MODE_SINGLE,
        secondaryDepthMode=DEPTH_MODE_STOCHASTIC, exponent=2.0,
        thickness=0.0, stochMapDivisor=4, dualAO=False, alphaTest=True,
        sampleCount=8, kernel="VAO", stochSamples=4, stochMaxCount=0,
        useRayInterval=True, stochMapJitter=True, stochMapGuardBand=512,
        stochasticDepthImpl="Ray", cullMode=None, ssRadiusCutoff=6.0,
        ssMaxRadius=512.0, samplingMode="shift")

    def __init__(self, props=None):
        super().__init__(props)
        for key, want in _SUPPORTED.items():
            if self.cfg[key] != want:
                raise NotImplementedError(
                    f"SVAO: {key}={self.cfg[key]!r} is not ported (only "
                    f"{want!r}; ROADMAP queue 1, item 12)")
        if int(self.cfg["stochMapDivisor"]) not in (1, 2, 4):
            raise NotImplementedError("SVAO: stochMapDivisor must be 1, 2 "
                                      "or 4 in shift mode")
        self._sd_graph: RenderGraph | None = None

    # --- sizing (SVAO.cpp:700-723) -----------------------------------------
    def _extra_guard(self) -> int:
        return int(self.cfg["stochMapGuardBand"]) \
            // int(self.cfg["stochMapDivisor"])

    def _stoch_map_size(self, full, include_guard: bool = True):
        d = int(self.cfg["stochMapDivisor"])
        w, h = -(-full[0] // d), -(-full[1] // d)
        if include_guard:
            g = self._extra_guard()
            w, h = w + 2 * g, h + 2 * g
        return w, h

    def reflect(self, ctx):
        return (PassReflection()
                .add_input("gbufferDepth").add_input("depth")
                .add_input("depth2", optional=True).add_input("normals")
                .add_input("color", optional=True)
                .add_output("ao").add_output("stencil")
                .add_output("internalRayMin").add_output("internalRayMax"))

    def unused_inputs(self, ctx):
        """depth2 is only read with DualDepth primary mode (not ported)."""
        return ("depth2",)

    # --- nested SD graph (SVAO.cpp:157-190) --------------------------------
    def _build_sd_graph(self):
        g = RenderGraph("Stochastic Depth")
        g.create_pass("StochasticDepthMap", "StochasticDepthMapRT", {
            "SampleCount": int(self.cfg["stochSamples"]),
            "CullMode": self.cfg["cullMode"] or "Back",
            "AlphaTest": bool(self.cfg["alphaTest"]),
            "RayInterval": bool(self.cfg["useRayInterval"]),
            "normalize": True,
            "Jitter": bool(self.cfg["stochMapJitter"]),
            "GuardBand": self._extra_guard(),
            "MaxCount": int(self.cfg["stochMaxCount"]),
        })
        g.mark_output("StochasticDepthMap.stochasticDepth")
        if self.scene is not None:
            g.set_scene(self.scene)
        return g

    def set_scene(self, scene):
        super().set_scene(scene)
        self._sd_graph = None

    def _vao_cfg(self, ctx, res=None):
        """Static VAOConfig; the resolution follows the depth input."""
        res = res or (ctx.width, ctx.height)
        return A.VAOConfig(
            radius=float(self.cfg["radius"]),
            exponent=float(self.cfg["exponent"]),
            thickness=float(self.cfg["thickness"]),
            ss_radius_cutoff=float(self.cfg["ssRadiusCutoff"]),
            ss_max_radius=float(self.cfg["ssMaxRadius"]),
            num_directions=int(self.cfg["sampleCount"]),
            resolution=res,
            low_resolution=self._stoch_map_size(res, include_guard=False),
            sd_guard=self._extra_guard())

    def execute(self, ctx, inputs, state=None):
        from .svao_shift import svao_phase1_shift, svao_phase2_shift
        cam = ctx.scene.camera
        depth = inputs["depth"]
        h, w = depth.shape
        cfg = self._vao_cfg(ctx, (w, h))
        normal_v = _normals_to_view(ctx, inputs["normals"])
        # the dictionary guard band is in full-res pixels
        guard = (ctx.guard_band * w) // max(ctx.width, 1)
        out = svao_phase1_shift(cam, cfg, depth, normal_v, guard,
                                bool(self.cfg["useRayInterval"]))
        ao_raw, stencil = out["ao_raw"], out["stencil"]

        if self._sd_graph is None:
            self._sd_graph = self._build_sd_graph()
            self._sd_graph.set_scene(ctx.scene)
        sd_w, sd_h = self._stoch_map_size((w, h))
        sd_ctx = RenderContext(width=sd_w, height=sd_h, scene=ctx.scene,
                               frame_index=ctx.frame_index, time=ctx.time,
                               dictionary=ctx.dictionary)
        marked, _, _ = self._sd_graph.execute(
            sd_ctx, {},
            external_inputs={"StochasticDepthMap.linearZ": depth,
                             "StochasticDepthMap.depthMap":
                                 inputs["gbufferDepth"],
                             "StochasticDepthMap.rayMin": out["ray_min"],
                             "StochasticDepthMap.rayMax": out["ray_max"]})
        sd_map = marked["StochasticDepthMap.stochasticDepth"]
        delta = svao_phase2_shift(cam, cfg, depth, normal_v, stencil, sd_map,
                                  bool(self.cfg["stochMapJitter"]),
                                  int(self.cfg["stochMapDivisor"]))
        ao = torch.where(stencil != 0, A.finalize(cfg, ao_raw + delta),
                         A.finalize(cfg, ao_raw))
        return {"ao": ao, "stencil": stencil,
                "internalRayMin": out["ray_min"],
                "internalRayMax": out["ray_max"]}, None
