"""SVAO — Stenciled Volumetric Ambient Occlusion, the paper's main pass
(counterpart of rtsdm_tpu/passes/svao.py; reference SVAO.cpp:192-456:
phase 1 -> nested SD graph -> phase 2, each a span of the context's
profiler: phase1, sd_map, phase2).

Ported configuration: samplingMode 'shift' (passes/svao_shift.py, K3 and
K4) or 'gather' (svao_phase1 / svao_phase2 below, per-pixel gathers);
kernel 'VAO' or 'HBAO'; primaryDepthMode 'SingleDepth' or 'DualDepth';
secondaryDepthMode 'StochasticDepth' with stochasticDepthImpl 'Ray'
(StochasticDepthMapRT, K7 or K5) or 'Raster' (StochasticDepthMap, K9),
'SingleDepth' (phase 1 alone), 'DualDepth' (phase 2 adds nothing, as in
the JAX pass) or 'Raytraced' (_phase2_raytraced: the brute-force interval
query of ops/rt.py); dualAO off or on; stochMapDivisor 1, 2 or 4. Every
other mode raises NotImplementedError, checked wherever the configuration
is read, since a graph script may change it after the pass was built.
"""
from __future__ import annotations

import math

import torch

from ..ops import ao as A
from ..ops import rt
from ..rendergraph.graph import RenderGraph
from ..rendergraph.render_pass import (PassReflection, RenderContext,
                                       RenderPass, register_pass)
from ..utils.math import (decode_normal_2x16, normalize, transform_point,
                          transform_vector, true_div)
from ..utils.sampling import AO_KERNEL_HBAO, AO_KERNEL_VAO, random_jitter
from . import stochastic_depth  # noqa: F401  (registers the nested SD pass)

DEPTH_MODE_SINGLE = "SingleDepth"
DEPTH_MODE_DUAL = "DualDepth"
DEPTH_MODE_STOCHASTIC = "StochasticDepth"
DEPTH_MODE_RAYTRACED = "Raytraced"

_KERNELS = {"VAO": AO_KERNEL_VAO, "HBAO": AO_KERNEL_HBAO}

# the values of each mode key that the port runs
_SUPPORTED = dict(samplingMode=("shift", "gather"),
                  primaryDepthMode=(DEPTH_MODE_SINGLE, DEPTH_MODE_DUAL),
                  secondaryDepthMode=(DEPTH_MODE_STOCHASTIC,
                                      DEPTH_MODE_SINGLE, DEPTH_MODE_DUAL,
                                      DEPTH_MODE_RAYTRACED),
                  stochasticDepthImpl=("Ray", "Raster"),
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
        """The refinement rays' cull mode: Back for the SD map, None for
        the Raytraced reference mode unless cullMode says otherwise
        (SVAO.cpp:528-531)."""
        if self.cfg["cullMode"]:
            return self.cfg["cullMode"]
        return "None" if self.cfg["secondaryDepthMode"] \
            == DEPTH_MODE_RAYTRACED else "Back"

    # --- sizing (SVAO.cpp:700-723) -----------------------------------------
    def _extra_guard(self) -> int:
        """The SD map's guard band in SD texels (the ray-traced SD map of
        the StochasticDepth secondary mode only)."""
        if self.cfg["secondaryDepthMode"] != DEPTH_MODE_STOCHASTIC \
                or self.cfg["stochasticDepthImpl"] != "Ray":
            return 0
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
        if self.cfg["stochasticDepthImpl"] == "Raster":
            props.update(linearize=True,
                         divisor=int(self.cfg["stochMapDivisor"]))
            return "StochasticDepthMap", props
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
        shift = self.cfg["samplingMode"] == "shift"
        with ctx.span("phase1"):
            normal_v = _normals_to_view(ctx, inputs["normals"])
            # the dictionary guard band is in full-res pixels
            guard = (ctx.guard_band * w) // max(ctx.width, 1)
            phase1 = svao_phase1_shift if shift else svao_phase1
            out = phase1(cam, cfg, depth, normal_v, guard,
                         bool(self.cfg["useRayInterval"]), depth2=depth2,
                         primary=primary, secondary=secondary,
                         trace_out_of_screen=bool(
                             self.cfg["traceOutOfScreen"]))
            ao_raw, stencil = out["ao_raw"], out["stencil"]
            result = {"stencil": stencil, "internalRayMin": out["ray_min"],
                      "internalRayMax": out["ray_max"]}
            if secondary == DEPTH_MODE_SINGLE:
                return {"ao": A.finalize(cfg, ao_raw), **result}, None

        sd_map = None
        if secondary == DEPTH_MODE_STOCHASTIC:
            with ctx.span("sd_map"):
                sd_map = self._sd_map(ctx, inputs, depth, out)
        with ctx.span("phase2"):
            if secondary == DEPTH_MODE_STOCHASTIC and shift:
                delta = svao_phase2_shift(cam, cfg, depth, normal_v, stencil,
                                          sd_map,
                                          bool(self.cfg["stochMapJitter"]),
                                          int(self.cfg["stochMapDivisor"]),
                                          depth2=depth2, primary=primary)
            else:
                delta = svao_phase2(
                    ctx.scene, cam, cfg, depth, depth2, normal_v, stencil,
                    sd_map, primary, secondary,
                    sd_jitter=bool(self.cfg["stochMapJitter"]),
                    alpha_test=bool(self.cfg["alphaTest"]),
                    cull=self._cull(),
                    ray_budget_fraction=float(
                        self.cfg["maxRayBudgetFraction"]),
                    rt_chunk=int(self.cfg["rtChunk"]))
            refined = stencil != 0
            if cfg.dual_ao:
                raw2 = ao_raw + delta
                # bright >= dark (SVAORaster2.ps.slang:62)
                raw2 = torch.stack([raw2[..., 0],
                                    torch.minimum(raw2[..., 0],
                                                  raw2[..., 1])], -1)
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


# ---------------------------------------------------------------------------
# gather sampling (SVAORaster.ps.slang phase 1, Common.slang calcAO2)
# ---------------------------------------------------------------------------

def _pixel_uv(h: int, w: int, device):
    """Pixel-centre uv [H, W, 2]."""
    xs = true_div(torch.arange(w, dtype=torch.float32, device=device) + 0.5,
                  w)
    ys = true_div(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
                  h)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def _basic(cam, cfg, depth, normal_v):
    h, w = depth.shape
    uv = _pixel_uv(h, w, depth.device)
    noise = A.dither_noise_for(h, w, device=depth.device)
    return uv, A.basic_init(cam, cfg, uv, depth, normal_v, noise)


def svao_phase1(cam, cfg, depth, normal_v, guard: int,
                use_ray_interval: bool = True, *, depth2=None,
                primary: str = DEPTH_MODE_SINGLE,
                secondary: str = DEPTH_MODE_STOCHASTIC,
                trace_out_of_screen: bool = False):
    """Phase 1 with per-pixel gathers (SVAORaster.ps.slang:29-122); the
    same outputs as svao_shift.svao_phase1_shift."""
    h, w = depth.shape
    dev = depth.device
    depth2 = depth if depth2 is None else depth2
    uv, basic = _basic(cam, cfg, depth, normal_v)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    # phase 1 only runs inside the guard band (SVAO.cpp:344-350)
    interior = ((xx >= guard) & (xx < w - guard)
                & (yy >= guard) & (yy < h - guard))
    sd_w = cfg.low_resolution[0] + 2 * cfg.sd_guard
    sd_h = cfg.low_resolution[1] + 2 * cfg.sd_guard
    vao = cfg.kernel == AO_KERNEL_VAO
    bright = torch.zeros((h, w), device=dev)
    dark = torch.zeros((h, w), device=dev)
    stencil = torch.zeros((h, w), dtype=torch.int32, device=dev)
    pix_rmin = torch.full((h, w), A.FLT_MAX, device=dev)
    pix_rmax = torch.zeros((h, w), device=dev)
    for alpha, r_i, bit in A.dir_params(cfg, dev):
        s = A.sample_init(cam, cfg, basic, alpha, r_i, uv)
        same_pix = A.is_same_pixel(cfg, uv, s["raster_uv"])
        vis, oz = A.eval_depth_sample(cam, cfg, basic, s, depth, None, None,
                                      init=True)
        if primary == DEPTH_MODE_DUAL:
            # evalDualVisibility refines only where a ray is required
            # (Common.slang:498-505)
            need2 = A.require_ray(cfg, basic, s, oz)
            vis2, oz2 = A.eval_depth_sample(cam, cfg, basic, s, depth2, vis,
                                            oz, init=False)
            vis = torch.where(need2, vis2, vis)
            oz = torch.where(need2, oz2, oz)
        same_contrib = ((s["sphere_start"] - s["sphere_end"]) / s["pdf"]
                        if vao else torch.zeros_like(vis))
        contrib = torch.where(same_pix, same_contrib, vis)
        bright = bright + torch.where(s["valid"], contrib, 0.0)

        force_ray = torch.zeros_like(same_pix)
        oz_int = oz
        if secondary == DEPTH_MODE_RAYTRACED and trace_out_of_screen:
            force_ray = force_ray | ~s["in_screen"]
        if cfg.sd_guard > 0:
            off = ~s["in_screen"]
            force_ray = force_ray | off
            oz_int = torch.where(off, A.FLT_MAX, oz)  # SVAORaster.ps.slang:75
        need = A.require_ray(cfg, basic, s, oz) | force_ray
        need = need & s["valid"] & ~same_pix & basic["valid"] & interior
        stencil = stencil | torch.where(need, bit, 0).to(torch.int32)

        if secondary == DEPTH_MODE_STOCHASTIC:
            if vao:
                oz_min = torch.minimum(
                    oz_int, basic["radius"] + cfg.thickness * basic["radius"]
                    + s["sphere_start"])
            else:
                oz_min = torch.minimum(oz_int, s["sphere_start"])
            rmin_v = torch.clamp(basic["pos_len"] - oz_min, min=0.0)
            rmax_v = torch.clamp(basic["pos_len"] - s["sphere_end"], min=0.0)
            if not use_ray_interval:
                rmin_v = torch.zeros_like(rmin_v)
                rmax_v = torch.ones_like(rmax_v)
            pix_rmin = torch.minimum(pix_rmin,
                                     torch.where(need, rmin_v, A.FLT_MAX))
            pix_rmax = torch.maximum(pix_rmax, torch.where(need, rmax_v, 0.0))
        else:
            dark = dark + torch.where(~need & s["valid"] & ~same_pix, vis,
                                      0.0)
        # the same-pixel contribution lands on both channels
        # (SVAORaster.ps.slang:55-59)
        dark = dark + torch.where(same_pix & s["valid"], same_contrib, 0.0)

    if secondary == DEPTH_MODE_STOCHASTIC:
        ray_min, ray_max = _intervals_to_sd_grid(
            cfg, basic["radius_px"], pix_rmin, pix_rmax, sd_h, sd_w)
    else:
        ray_min = torch.full((sd_h, sd_w), A.FLT_MAX, device=dev)
        ray_max = torch.zeros((sd_h, sd_w), device=dev)
    scale = (2.0 if vao else 1.0) / cfg.num_directions
    bg = ~basic["valid"]
    bright = torch.where(bg, 1.0, bright * scale)
    if cfg.dual_ao:
        ao_raw = torch.stack([bright, torch.where(bg, 1.0, dark * scale)],
                             -1)
    else:
        ao_raw = bright
    stencil = torch.where(bg, 0, stencil)
    return dict(ao_raw=ao_raw, stencil=stencil, ray_min=ray_min,
                ray_max=ray_max)


def svao_phase2(scene, cam, cfg, depth, depth2, normal_v, stencil, sd_map,
                primary: str, secondary: str, sd_jitter: bool = True,
                alpha_test: bool = True, cull: str = "Back",
                ray_budget_fraction: float = 0.5, rt_chunk: int = 256):
    """calcAO2 (Common.slang:523-663) with per-pixel gathers: the additive
    correction to phase 1's raw AO on stenciled directions, [H, W]
    ([H, W, 2] under cfg.dual_ao, the dark channel's 0). StochasticDepth
    reads sd_map [sd_h, sd_w, k] at each sample's SD texel; Raytraced
    traces the rays; any other secondary mode adds nothing."""
    h, w = depth.shape
    dev = depth.device
    uv, basic = _basic(cam, cfg, depth, normal_v)
    delta = torch.zeros((h, w), device=dev)
    layer = depth2 if primary == DEPTH_MODE_DUAL else depth
    if secondary == DEPTH_MODE_STOCHASTIC:
        k = sd_map.shape[-1]
        depth_range = cam.far_z - cam.near_z
        low = A._f32(cfg.low_resolution, dev)
        for alpha, r_i, bit in A.dir_params(cfg, dev):
            on = (stencil & bit) != 0
            s = A.sample_init(cam, cfg, basic, alpha, r_i, uv)
            vis, oz = A.eval_depth_sample(cam, cfg, basic, s, layer, None,
                                          None, init=True)
            old_vis = vis
            # out of the screen: start from the neutral sample
            # (Common.slang:581)
            rvis, roz = A.reset_sample(cfg, vis)
            vis = torch.where(s["in_screen"], vis, rvis)
            oz = torch.where(s["in_screen"], oz, roz)
            sd_px = A.uv_to_sd_pixel(cfg, s["sample_uv"])
            jit = random_jitter(sd_px[..., 0], sd_px[..., 1], sd_jitter)
            sd_uv = (sd_px.to(torch.float32) - cfg.sd_guard + jit) / low
            sd_vals = sd_map[sd_px[..., 1], sd_px[..., 0]]      # [H, W, k]
            for kk in range(k):
                lin = sd_vals[..., kk] * depth_range + cam.near_z
                sp_v = cam.uv_to_view_space(sd_uv, lin)
                vis, oz = A.add_sample(cfg, basic, s, sp_v, vis, oz,
                                       init=False)
            delta = delta + torch.where(on, vis - old_vis, 0.0)
    elif secondary == DEPTH_MODE_RAYTRACED:
        delta = _phase2_raytraced(scene, cam, cfg, layer, stencil, basic, uv,
                                  alpha_test, cull, ray_budget_fraction,
                                  rt_chunk)
    scale = (2.0 if cfg.kernel == AO_KERNEL_VAO else 1.0) \
        / cfg.num_directions
    delta = delta * scale
    if cfg.dual_ao:
        # refined visibility lands on the bright channel only
        delta = torch.stack([delta, torch.zeros_like(delta)], -1)
    return delta


def ray_budget(n_pairs: int, fraction: float) -> int:
    """The Raytraced mode's ray budget: max(1024, n_pairs * fraction)
    rounded up to a power of two."""
    budget = max(1024, int(n_pairs * fraction))
    return 1 << int(math.ceil(math.log2(budget)))


def _phase2_raytraced(scene, cam, cfg, layer, stencil, basic, uv,
                      alpha_test: bool, cull: str, budget_fraction: float,
                      rt_chunk: int):
    """The ray fallback (Common.slang:598-651): the stenciled (pixel,
    direction) pairs, ranked over the flattened [nd, H, W] mask, take the
    first `ray_budget` slots; pairs past the budget keep their raster
    visibility. Only the filled slots are traced (the JAX pass traces the
    padded budget too, with tmax = -1, and drops their results)."""
    h, w = layer.shape
    dev = layer.device
    nd = cfg.num_directions
    vao = cfg.kernel == AO_KERNEL_VAO
    # the inverse view matrix on the host, so that the card and the CPU
    # agree to the bit
    inv_view = torch.linalg.inv(cam.view_mat.cpu()).to(dev)
    pos_len = basic["pos_len"]
    per = []
    for alpha, r_i, bit in A.dir_params(cfg, dev):
        s = A.sample_init(cam, cfg, basic, alpha, r_i, uv)
        vis, oz = A.eval_depth_sample(cam, cfg, basic, s, layer, None, None,
                                      True)
        old_vis = vis
        rvis, roz = A.reset_sample(cfg, vis)
        vis = torch.where(s["in_screen"], vis, rvis)
        oz = torch.where(s["in_screen"], oz, roz)
        snapped = A.get_snapped_uv(s["sample_uv"], cfg.resolution)
        dir_w = transform_vector(inv_view, normalize(
            cam.uv_to_view_space(snapped, torch.ones_like(layer))))
        ratio = s["sample_len"] / pos_len
        t_halo = (pos_len - s["sphere_start"] - basic["radius"]
                  - cfg.thickness * basic["radius"]) * ratio
        t_inside = (pos_len - s["sphere_end"]) * ratio
        t_sphere_start = (pos_len - s["sphere_start"]) * ratio
        eps = basic["radius"] * 0.01
        if vao:
            tmin = torch.clamp(t_halo, min=0.0)
        else:
            # HBAO rays span [sphereStart, sphereEnd] only
            # (Common.slang:623-627); every hit counts as inside
            tmin = t_sphere_start
            t_sphere_start = torch.zeros_like(t_sphere_start)
        tmin = torch.where(s["in_screen"],
                           torch.maximum(tmin, (pos_len - oz) * ratio + eps),
                           tmin)
        per.append(dict(bit=(stencil & bit) != 0, vis=vis, old_vis=old_vis,
                        dir_w=dir_w, tmin=tmin, tmax=t_inside, t_halo=t_halo,
                        t_sphere_start=t_sphere_start, ratio=ratio,
                        sphere_start=s["sphere_start"],
                        sphere_end=s["sphere_end"], pdf=s["pdf"]))

    # the first `budget` stenciled pairs in [nd, H, W] order are traced
    budget = ray_budget(h * w * nd, budget_fraction)
    mask = torch.stack([d["bit"] for d in per]).reshape(-1)
    pairs = torch.nonzero(mask)[:budget, 0]

    def flat(key):
        a = torch.stack([d[key] for d in per])
        return a.reshape((nd * h * w,) + a.shape[3:])[pairs]

    dirs = flat("dir_w")
    origins = cam.pos_w.expand(dirs.shape)
    t_last_halo, t_first_in = rt.vao_interval_query(
        scene, origins, dirs, flat("tmin"), flat("tmax"),
        flat("t_sphere_start"), chunk=rt_chunk,
        cull=rt.CULL_BACK if cull == "Back" else rt.CULL_NONE,
        alpha_test=alpha_test)
    halo_all = torch.full((nd * h * w,), -float("inf"), device=dev)
    in_all = torch.full((nd * h * w,), float("inf"), device=dev)
    halo_all[pairs] = t_last_halo
    in_all[pairs] = t_first_in
    halo_all = halo_all.reshape(nd, h, w)
    in_all = in_all.reshape(nd, h, w)

    delta = torch.zeros((h, w), device=dev)
    for i, d in enumerate(per):
        # fold the traced hits into the initial ray data (aoAnyHit: the
        # trace starts from the initial guesses)
        if vao:
            t_halo = torch.maximum(d["t_halo"], halo_all[i])
            t_in = torch.minimum(d["tmax"], in_all[i])
            ratio = d["ratio"]
            sphere_vis = A.calc_visibility(
                cfg, pos_len - t_in / ratio, d["sphere_start"],
                d["sphere_end"], d["pdf"], basic["radius"])
            halo_vis = A.calc_halo_visibility(
                cfg, pos_len - t_halo / ratio, d["sphere_start"],
                d["sphere_end"], d["pdf"], basic["radius"])
            vis = torch.minimum(d["vis"], torch.minimum(sphere_vis,
                                                        halo_vis))
        else:
            # HBAO: the nearest committed hit becomes the sample
            # (Common.slang:646-650)
            t_first = torch.where(torch.isfinite(in_all[i]), in_all[i], 0.0)
            sp_w = cam.pos_w + d["dir_w"] * t_first[..., None]
            sp_v = transform_point(cam.view_mat, sp_w)[..., :3]
            s_like = dict(sphere_start=d["sphere_start"],
                          sphere_end=d["sphere_end"], pdf=d["pdf"])
            vis, _ = A.add_sample(cfg, basic, s_like, sp_v, d["vis"],
                                  torch.full_like(d["vis"], A.FLT_MAX),
                                  init=False)
        delta = delta + torch.where(d["bit"], vis - d["old_vis"], 0.0)
    return delta
