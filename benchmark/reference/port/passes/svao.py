"""SVAO — Stenciled Volumetric Ambient Occlusion, the paper's main pass
(counterpart of rtsdm_tpu/passes/svao.py; reference SVAO.cpp:192-456:
phase 1 -> nested SD graph -> phase 2).

Ported configuration, cut to what the benchmark's graphs run:
samplingMode 'shift' (passes/svao_shift.py, K3 and K4); kernel 'VAO';
primaryDepthMode 'SingleDepth' or 'DualDepth'; secondaryDepthMode
'StochasticDepth' with stochasticDepthImpl 'Ray' (StochasticDepthMapRT);
dualAO off or on; stochMapDivisor 1, 2 or 4. Every other mode raises
NotImplementedError (the port's gather sampling, HBAO kernel, Raster SD
and Raytraced modes are not in this copy).
"""
from __future__ import annotations

import math

import torch

from ..ops import ao as A
from ..rendergraph.graph import RenderGraph
from ..rendergraph.render_pass import (PassReflection, RenderContext,
                                       RenderPass, register_pass)
from ..utils.math import decode_normal_2x16, normalize, transform_vector
from ..utils.sampling import AO_KERNEL_VAO
from . import stochastic_depth  # noqa: F401  (registers the nested SD pass)

DEPTH_MODE_SINGLE = "SingleDepth"
DEPTH_MODE_DUAL = "DualDepth"
DEPTH_MODE_STOCHASTIC = "StochasticDepth"

_KERNELS = {"VAO": AO_KERNEL_VAO}

# the values of each mode key that the port runs
_SUPPORTED = dict(samplingMode=("shift",),
                  primaryDepthMode=(DEPTH_MODE_SINGLE, DEPTH_MODE_DUAL),
                  secondaryDepthMode=(DEPTH_MODE_STOCHASTIC,),
                  stochasticDepthImpl=("Ray",),
                  kernel=tuple(_KERNELS), dualAO=(False, True),
                  stochMapDivisor=(1, 2, 4))


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
        rayPipeline=True, thickness=0.0, stochMapDivisor=4, dualAO=False, alphaTest=True,
        sampleCount=8, kernel="VAO", stochSamples=4, stochMaxCount=0,
        useRayInterval=True, stochMapJitter=True, stochMapGuardBand=512,
        traceOutOfScreen=False, stochasticDepthImpl="Ray", cullMode=None,
        ssRadiusCutoff=6.0, ssMaxRadius=512.0, maxRayBudgetFraction=0.5,
        rtChunk=256, samplingMode="shift", usePallas=True)

    def __init__(self, props=None):
        super().__init__(props)
        self._check_supported()
        self._sd_graph: RenderGraph | None = None
        self._sd_key = None

    def _check_supported(self):
        """Raise NotImplementedError for a mode the port does not run."""
        for key, allowed in _SUPPORTED.items():
            if self.cfg[key] not in allowed:
                raise NotImplementedError(
                    f"SVAO: {key}={self.cfg[key]!r} is not ported (only "
                    f"{' or '.join(map(repr, allowed))})")

    def _cull(self) -> str:
        """The refinement rays' cull mode: Back for the SD map unless
        cullMode says otherwise (SVAO.cpp:528-531)."""
        return self.cfg["cullMode"] or "Back"

    # --- sizing (SVAO.cpp:700-723) -----------------------------------------
    def _extra_guard(self) -> int:
        """The SD map's guard band in SD texels."""
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
        """depth2 is only read with DualDepth primary mode: otherwise the
        graph prunes the DepthPeeling chain that feeds it."""
        if self.cfg["primaryDepthMode"] != DEPTH_MODE_DUAL:
            return ("depth2",)
        return ()

    # --- nested SD graph (SVAO.cpp:157-190) --------------------------------
    def _sd_pass(self):
        """(pass type, properties) of the nested graph's SD pass."""
        props = {"SampleCount": int(self.cfg["stochSamples"]),
                 "CullMode": self._cull(),
                 "AlphaTest": bool(self.cfg["alphaTest"]),
                 "Alpha": 1.5 / int(self.cfg["stochSamples"]),
                 "RayInterval": bool(self.cfg["useRayInterval"])}
        props.update(normalize=True, Jitter=bool(self.cfg["stochMapJitter"]),
                     GuardBand=self._extra_guard(),
                     MaxCount=int(self.cfg["stochMaxCount"]),
                     usePallas=bool(self.cfg["usePallas"]))
        return "StochasticDepthMapRT", props

    def _build_sd_graph(self, spec=None):
        """The nested SD graph of `spec` = (pass type, properties); without
        one, the modes are checked and _sd_pass gives it."""
        if spec is None:
            self._check_supported()
            spec = self._sd_pass()
        pass_type, props = spec
        g = RenderGraph("Stochastic Depth")
        g.create_pass("StochasticDepthMap", pass_type, props)
        g.mark_output("StochasticDepthMap.stochasticDepth")
        if self.scene is not None:
            g.set_scene(self.scene)
        return g

    def _nested_graph(self, scene):
        """The nested SD graph, rebuilt when the properties it was built
        from have changed since (execute has checked the modes)."""
        spec = self._sd_pass()
        key = (spec[0], tuple(sorted(spec[1].items())))
        if self._sd_graph is None or self._sd_key != key:
            self._sd_graph = self._build_sd_graph(spec)
            self._sd_key = key
        self._sd_graph.set_scene(scene)
        return self._sd_graph

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
            kernel=_KERNELS[self.cfg["kernel"]],
            resolution=res,
            low_resolution=self._stoch_map_size(res, include_guard=False),
            sd_guard=self._extra_guard(),
            dual_ao=bool(self.cfg["dualAO"]))

    def execute(self, ctx, inputs, state=None):
        from .svao_shift import svao_phase1_shift, svao_phase2_shift
        self._check_supported()
        cam = ctx.scene.camera
        depth = inputs["depth"]
        depth2 = inputs.get("depth2", depth)
        h, w = depth.shape
        cfg = self._vao_cfg(ctx, (w, h))
        primary = self.cfg["primaryDepthMode"]
        secondary = self.cfg["secondaryDepthMode"]
        normal_v = _normals_to_view(ctx, inputs["normals"])
        # the dictionary guard band is in full-res pixels
        guard = (ctx.guard_band * w) // max(ctx.width, 1)
        out = svao_phase1_shift(cam, cfg, depth, normal_v, guard,
                     bool(self.cfg["useRayInterval"]), depth2=depth2,
                     primary=primary, secondary=secondary,
                     trace_out_of_screen=bool(self.cfg["traceOutOfScreen"]))
        ao_raw, stencil = out["ao_raw"], out["stencil"]
        result = {"stencil": stencil, "internalRayMin": out["ray_min"],
                  "internalRayMax": out["ray_max"]}
        sd_map = self._sd_map(ctx, inputs, depth, out)
        delta = svao_phase2_shift(cam, cfg, depth, normal_v, stencil, sd_map,
                                  bool(self.cfg["stochMapJitter"]),
                                  int(self.cfg["stochMapDivisor"]),
                                  depth2=depth2, primary=primary)
        refined = stencil != 0
        if cfg.dual_ao:
            raw2 = ao_raw + delta
            # bright >= dark (SVAORaster2.ps.slang:62)
            raw2 = torch.stack([raw2[..., 0],
                                torch.minimum(raw2[..., 0], raw2[..., 1])],
                               -1)
            ao = torch.where(refined[..., None], A.finalize(cfg, raw2),
                             A.finalize(cfg, ao_raw))
        else:
            ao = torch.where(refined, A.finalize(cfg, ao_raw + delta),
                             A.finalize(cfg, ao_raw))
        ctx.debug_print("svao.ao_raw", ao_raw)
        ctx.debug_print("svao.delta", delta)
        ctx.debug_print("svao.stencil", stencil)
        ctx.debug_print("svao.ao", ao)
        return {"ao": ao, **result}, None

    def _sd_map(self, ctx, inputs, depth, out):
        """Run the nested SD graph over phase 1's ray intervals; publishes
        the map as ctx.dictionary["SD_MAP"]."""
        h, w = depth.shape
        sd_graph = self._nested_graph(ctx.scene)
        sd_w, sd_h = self._stoch_map_size((w, h))
        # PixelDebug reaches the nested graph: the selected pixel maps to
        # SD texel (x // div + guard, y // div + guard), and the log is
        # shared, so the nested taps land in the outer frame's log
        sd_dbg = None
        if ctx.pixel_debug is not None:
            div = int(self.cfg["stochMapDivisor"])
            g_sd = self._extra_guard()
            sd_dbg = (ctx.pixel_debug[0] // div + g_sd,
                      ctx.pixel_debug[1] // div + g_sd)
        sd_ctx = RenderContext(width=sd_w, height=sd_h, scene=ctx.scene,
                               frame_index=ctx.frame_index, time=ctx.time,
                               dictionary=ctx.dictionary,
                               profiler=ctx.profiler, pixel_debug=sd_dbg)
        sd_ctx.debug_log = ctx.debug_log
        marked, _, _ = sd_graph.execute(
            sd_ctx, {},
            external_inputs={"StochasticDepthMap.linearZ": depth,
                             "StochasticDepthMap.depthMap":
                                 inputs["gbufferDepth"],
                             "StochasticDepthMap.rayMin": out["ray_min"],
                             "StochasticDepthMap.rayMax": out["ray_max"]})
        sd_map = marked["StochasticDepthMap.stochasticDepth"]
        ctx.dictionary["SD_MAP"] = sd_map
        return sd_map

