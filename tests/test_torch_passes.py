"""The passes of the SVAO_small graph that the port adds, each against its
rtsdm_tpu counterpart on the CPU, on scenes carried across by
scene_from_numpy (Arcade@small: textures, an env map and a directional
light; CornellBox: a point light, no env map) and on seeded inputs.

Tolerances (float32; XLA:CPU contracts some a*b+c into fused multiply-
adds and its transcendental functions round differently from PyTorch's):
  EnvMapPass, ToneMapper, CrossBilateralBlur, TAA: 1e-5 relative + 1e-5
    absolute;
  DeferredLighting (the shading core on one shared G-buffer): 1e-5 + 1e-5;
  ForwardLighting (both on the port's re-raster): 2e-5 + 2e-5;
  ImageEquation, GuardBand: exact.
"""
import collections
import logging
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.passes import blur as BJ  # noqa: E402
from rtsdm_tpu.passes import depth_chain as DJ  # noqa: E402
from rtsdm_tpu.passes import gbuffer as GJ  # noqa: E402
from rtsdm_tpu.passes import image_equation as IJ  # noqa: E402
from rtsdm_tpu.passes import lighting as LJ  # noqa: E402
from rtsdm_tpu.passes import temporal as TJ  # noqa: E402
from rtsdm_tpu.passes import tonemap as MJ  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RCJ  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu_torch.passes import blur as BT  # noqa: E402
from rtsdm_tpu_torch.passes import depth_chain as DT  # noqa: E402
from rtsdm_tpu_torch.passes import gbuffer as GT  # noqa: E402
from rtsdm_tpu_torch.passes import image_equation as IT  # noqa: E402
from rtsdm_tpu_torch.passes import lighting as LT  # noqa: E402
from rtsdm_tpu_torch.passes import temporal as TT  # noqa: E402
from rtsdm_tpu_torch.passes import tonemap as MT  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402

SCENES = {"Arcade": (64, 36), "CornellBox": (48, 48)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    w, h = SCENES[request.param]
    sj = PJ.load_scene(request.param, aspect=w / h)
    return request.param, sj, carry(sj), w, h


def _run(cls_j, cls_t, props, sj, st, w, h, inputs, state=(None, None),
         guard=0):
    """Execute one pass in both packages on the same numpy inputs."""
    pj, pt = cls_j(dict(props)), cls_t(dict(props))
    pj.set_scene(sj)
    pt.set_scene(st)
    cj = RCJ(width=w, height=h, scene=sj, dictionary={"guardBand": guard})
    ct = RenderContext(width=w, height=h, scene=st,
                       dictionary={"guardBand": guard})
    oj, sj_new = pj.execute(cj, {k: jnp.asarray(v) for k, v in
                                 inputs.items()}, state[0])
    ot, st_new = pt.execute(ct, {k: torch.as_tensor(v) for k, v in
                                 inputs.items()}, state[1])
    return ({k: np.asarray(v) for k, v in oj.items()},
            {k: v.numpy() for k, v in ot.items()}, (sj_new, st_new))


def _close(got, want, tol):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_env_map_pass(scene_pair):
    name, sj, st, w, h = scene_pair
    oj, ot, _ = _run(LJ.EnvMapPass, LT.EnvMapPass, {}, sj, st, w, h,
                     {"depth": np.zeros((h, w), np.float32)})
    _close(ot["color"], oj["color"], 1e-5)
    if name == "Arcade":
        assert np.ptp(ot["color"]) > 0.1      # the sky map, not a fill


def _gbuffer_np(st, w, h):
    return {k: v.numpy() for k, v in GT.raster_gbuffer(st, w, h).items()}


def _visibility(st, g, w, h):
    p = LT.RayShadow({})
    p.set_scene(st)
    out, _ = p.execute(RenderContext(width=w, height=h, scene=st),
                       {"posW": torch.as_tensor(g["posW"]),
                        "normalW": torch.as_tensor(g["normW"])})
    return out["visibility"].numpy()


def test_deferred_lighting_on_one_gbuffer(scene_pair):
    """The shading core (_shade: materials, texture pages, env terms, every
    light's BSDF term with its shadow) on one G-buffer."""
    name, sj, st, w, h = scene_pair
    g = _gbuffer_np(st, w, h)
    vis = _visibility(st, g, w, h)
    env = np.full((h, w, 3), 0.3, np.float32)
    oj, ot, _ = _run(LJ.DeferredLighting, LT.DeferredLighting, {}, sj, st, w,
                     h, {"posW": g["posW"], "normW": g["normW"],
                         "mtlData": g["mtlData"], "texC": g["texC"],
                         "color": env, "visibilityBuffer": vis})
    _close(ot["color"], oj["color"], 1e-5)
    assert (vis == 0.0).any()                 # some pixels are in shadow


def test_forward_lighting(scene_pair):
    """ForwardLighting re-rasters the scene, as the reference graph does.
    The reference's CPU raster is its XLA tier, which differs from the
    Pallas raster the port is held to (tests/test_torch_raster.py) on a few
    percent of edge pixels here, so the reference pass is handed the
    port's G-buffer for its re-raster: this holds the pass, not the
    raster."""
    name, sj, st, w, h = scene_pair
    g = _gbuffer_np(st, w, h)
    env = np.full((h, w, 3), 0.3, np.float32)
    props = dict(envMapIntensity=0.25, ambientIntensity=0.25,
                 lightIntensity=0.5)
    port_raster = {k: jnp.asarray(v) for k, v in g.items()}
    with mock.patch.object(LJ, "raster_gbuffer",
                           lambda *a, **k: port_raster):
        oj, ot, _ = _run(LJ.ForwardLighting, LT.ForwardLighting, props, sj,
                         st, w, h, {"depth": g["depth"], "color": env,
                                    "visibilityBuffer":
                                        _visibility(st, g, w, h)})
    _close(ot["color"], oj["color"], 2e-5)


@pytest.mark.parametrize("props", [
    dict(operator="Linear", clamp=False),
    dict(operator="Reinhard"),
    dict(operator="ReinhardModified", whiteMaxLuminance=2.0),
    dict(operator="HejiHableAlu"),
    dict(operator="HableUc2"),
    dict(operator="Aces", clamp=True),
    dict(operator="Linear", autoExposure=True),
    dict(operator="Reinhard", whiteBalance=True, whitePoint=4500.0,
         exposureCompensation=0.5, fNumber=2.0),
], ids=lambda p: "-".join(f"{k}={v}" for k, v in p.items()))
def test_tone_mapper(props):
    rng = np.random.default_rng(4)
    src = rng.uniform(0.0, 4.0, (20, 24, 3)).astype(np.float32)
    oj, ot, _ = _run(MJ.ToneMapper, MT.ToneMapper, props, None, None, 24,
                     20, {"src": src})
    _close(ot["dst"], oj["dst"], 1e-5)


@pytest.mark.parametrize("better_slope", [True, False])
def test_cross_bilateral_blur(better_slope):
    rng = np.random.default_rng(6)
    h, w, g = 30, 40, 4
    ao = rng.uniform(0, 1, (h, w)).astype(np.float32)
    depth = (5.0 + np.cumsum(rng.uniform(0, 0.2, (h, w)), 1)
             ).astype(np.float32)
    props = dict(kernelRadius=4, betterSlope=better_slope)
    oj, ot, _ = _run(BJ.CrossBilateralBlur, BT.CrossBilateralBlur, props,
                     None, None, w, h, {"color": ao, "linear depth": depth},
                     guard=g)
    _close(ot["colorOut"], oj["colorOut"], 1e-5)


@pytest.mark.parametrize("formula", ["I0[xy].r * I1[xy]", "I0[xy].rrra",
                                     "I0[xy] + 2.0 * I1[xy].g"])
def test_image_equation(formula):
    rng = np.random.default_rng(8)
    i0 = rng.uniform(0, 1, (12, 16)).astype(np.float32)
    i1 = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    oj, ot, _ = _run(IJ.ImageEquation, IT.ImageEquation,
                     dict(formula=formula, format="RGBA32Float"), None, None,
                     16, 12, {"I0": i0, "I1": i1})
    assert ot["out"].shape == (12, 16, 4)
    np.testing.assert_array_equal(ot["out"], oj["out"])


def test_taa_two_frames_with_motion():
    """TAA over two frames: history valid from the second frame, a
    non-zero motion field (up to +-3 px), state threaded by the caller."""
    rng = np.random.default_rng(10)
    h, w = 24, 40
    props = dict(alpha=0.1, colorBoxSigma=0.5, antiFlicker=True)
    pj, pt = TJ.TAA(dict(props)), TT.TAA(dict(props))
    cj, ct = RCJ(width=w, height=h), RenderContext(width=w, height=h)
    state_j, state_t = pj.init_state(cj), pt.init_state(ct)
    for _ in range(2):
        color = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
        mvec = (rng.uniform(-3, 3, (h, w, 2))
                / np.asarray([w, h])).astype(np.float32)
        oj, state_j = pj.execute(cj, {"colorIn": jnp.asarray(color),
                                      "motionVecs": jnp.asarray(mvec)},
                                 state_j)
        ot, state_t = pt.execute(ct, {"colorIn": torch.as_tensor(color),
                                      "motionVecs": torch.as_tensor(mvec)},
                                 state_t)
        _close(ot["colorOut"].numpy(), np.asarray(oj["colorOut"]), 1e-5)
    assert state_t["valid"]


def test_guard_band_dictionary():
    for g in (0, 8, 64):
        cj = RCJ(width=200, height=120, dictionary={})
        ct = RenderContext(width=200, height=120, dictionary={})
        DJ.GuardBand({"guardBand": g}).execute(cj, {})
        DT.GuardBand({"guardBand": g}).execute(ct, {})
        assert ct.dictionary == cj.dictionary
        assert ct.guard_band == g


def test_gbuffer_schema_matches_reference(caplog):
    """GBufferRaster takes the reference's keys: the script's sampleCount
    and useAlphaTest log no 'Unknown field'; useAlphaTest and maxPerTile
    change nothing, as in the reference package (whose raster neither
    alpha-tests nor caps tiles); what the port cannot do raises."""
    assert set(GT.GBufferRaster.SCHEMA) == set(GJ.GBufferRaster.SCHEMA)
    assert GT.GBufferRaster.SCHEMA == GJ.GBufferRaster.SCHEMA
    st = carry(PJ.arcade(aspect=1.0))
    outs = []
    with caplog.at_level(logging.WARNING):
        for props in (dict(sampleCount=8, useAlphaTest=True, cull="Back"),
                      dict(useAlphaTest=False, maxPerTile=64),
                      dict(adjustShadingNormals=False, forceCullMode=True)):
            p = GT.GBufferRaster(props)
            out, _ = p.execute(RenderContext(width=32, height=32, scene=st),
                               {})
            outs.append(out)
    assert "Unknown field" not in caplog.text
    for o in outs[1:]:
        for k in outs[0]:
            assert torch.equal(o[k], outs[0][k]), k
    for bad in (dict(outputSize="Half"), dict(samplePattern="Halton")):
        with pytest.raises(NotImplementedError):
            GT.GBufferRaster(bad).execute(
                RenderContext(width=32, height=32, scene=st), {})


def _svao_small_renderer(w=32, h=32):
    """SVAO_small.py at w x h with no guard band and a 16-texel SD guard
    band (8 x 8 SD texels + 2 x 4: the script's 512 would trace 264 x 264
    rays for a 32 x 32 frame)."""
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = Renderer(w, h, device="cpu")
    run_script(str(Path(__file__).resolve().parents[1] / "scripts"
                   / "SVAO_small.py"), m)
    m.active_graph.get_pass("GuardBand").cfg["guardBand"] = 0
    m.active_graph.get_pass("SVAO").cfg["stochMapGuardBand"] = 16
    m.loadScene("CornellBox")
    m.clock.pause()
    return m


@pytest.mark.parametrize("props", [{"kernel": "HBAO"},
                                   {"secondaryDepthMode": "Raytraced"},
                                   {"samplingMode": "gather"},
                                   {"stochasticDepthImpl": "Coverage"}])
def test_svao_mode_set_after_construction_raises(props):
    """A graph script may change SVAO's modes after the pass was built
    (bench_configs.py:48-49 does so through cfg.update): a mode the port
    does not run raises NotImplementedError at render time instead of
    rendering another one."""
    m = _svao_small_renderer()
    m.renderFrame()
    m.active_graph.get_pass("SVAO").cfg.update(props)
    with pytest.raises(NotImplementedError):
        m.renderFrame()


def test_svao_raster_set_after_construction_renders_raster_sd():
    """stochasticDepthImpl 'Raster' set after the first frame: the nested
    graph is rebuilt around StochasticDepthMap (K9's path), with the
    un-guarded SD grid, and the ray-traced SD no longer runs."""
    from rtsdm_tpu_torch.ops import rt_cuda
    from rtsdm_tpu_torch.passes import stochastic_depth as SDT
    m = _svao_small_renderer()
    svao = m.active_graph.get_pass("SVAO")
    m.renderFrame()
    assert svao._sd_graph.passes["StochasticDepthMap"].pass_type == \
        "StochasticDepthMapRT"
    svao.cfg.update({"stochasticDepthImpl": "Raster"})
    calls = []

    def rec(*a, **kw):
        calls.append((kw["width"], kw["height"]))
        return real(*a, **kw)

    def no_trace(*a, **kw):
        raise AssertionError("the ray-traced SD ran")

    real = SDT.raster_stochastic
    with mock.patch.object(SDT, "raster_stochastic", rec), \
            mock.patch.object(rt_cuda, "sd_trace_blocks", no_trace), \
            mock.patch.object(rt_cuda, "sd_trace_resident_blocks", no_trace):
        out = m.renderFrame()
    assert svao._sd_graph.passes["StochasticDepthMap"].pass_type == \
        "StochasticDepthMap"
    assert calls == [(8, 8)]           # ceil(32 / 4), no guard band
    assert svao._stoch_map_size((32, 32)) == (8, 8)
    ao = out["AmbientOcclusion.out"][..., 0]
    assert bool(torch.isfinite(ao).all()) and float(ao.max()) <= 1.0


@pytest.mark.parametrize("mode,peeled,traced", [
    ({"primaryDepthMode": "DualDepth"}, True, True),
    ({"secondaryDepthMode": "SingleDepth"}, False, False)])
def test_svao_depth_modes_set_after_construction(mode, peeled, traced):
    """SVAO's depth modes set after the first frame, as a graph script may
    set them: under DualDepth the graph's liveness, computed at each
    execute, brings back the DepthPeeling chain that feeds depth2 (pruned
    under SingleDepth); secondary SingleDepth runs phase 1 alone, with no
    SD trace and no SD grid guard band."""
    from rtsdm_tpu_torch.ops import rt_cuda
    from rtsdm_tpu_torch.passes import depth_chain
    m = _svao_small_renderer()
    svao = m.active_graph.get_pass("SVAO")
    runs = collections.Counter()

    def counted(cls, name):
        real = cls.execute

        def execute(self, *a, **kw):
            runs[name] += 1
            return real(self, *a, **kw)
        return mock.patch.object(cls, "execute", execute)

    def trace(real):
        def f(*a, **kw):
            runs["trace"] += 1
            return real(*a, **kw)
        return f

    with counted(depth_chain.DepthPeeling, "peel"), \
            mock.patch.object(rt_cuda, "sd_trace_blocks",
                              trace(rt_cuda.sd_trace_blocks)), \
            mock.patch.object(rt_cuda, "sd_trace_resident_blocks",
                              trace(rt_cuda.sd_trace_resident_blocks)):
        m.renderFrame()
        assert runs == {"trace": 1}
        runs.clear()
        svao.cfg.update(mode)
        out = m.renderFrame()
    assert runs["peel"] == int(peeled) and runs["trace"] == int(traced)
    assert svao._extra_guard() == (4 if traced else 0)     # 16 // 4
    ao = out["AmbientOcclusion.out"][..., 0]
    assert bool(torch.isfinite(ao).all())
    assert 0.0 <= float(ao.min()) < 0.9 and float(ao.max()) <= 1.0
