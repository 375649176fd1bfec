"""The SVAO + ray-traced SD slice of rtsdm_tpu_torch against rtsdm_tpu on
the CPU, stage by stage and end to end (CornellBox 64x64, sampleCount 4,
stochSamples 2, stochMapGuardBand 32, stochMapDivisor 4).

The reference runs the stages in the headline benchmark's order: the
G-buffer (Pallas raster and attribute fetch in interpret mode, op by op),
phase 1 (svao_phase1_shift), the nested SD graph with the streaming Pallas
trace in interpret mode, phase 2 (svao_phase2_shift), finalize. The port
runs its public path: raster_gbuffer -> linearize -> packed view normals
-> SVAO.execute.

Tolerances: tri_id, NDC depth, the stencil and the SD-grid ray intervals
are bit-exact (the intervals to 1 ulp, see test_phase1); phase 1's raw AO
and phase 2's correction agree to 1e-5 (float32 math that XLA:CPU partly
fuses into multiply-adds); the final AO field, from the reference G-buffer
and end to end from the port's own, meets the reference's own cross-tier
bound (tests/test_svao.py:160-162): below 2e-2 everywhere and below 1e-4
on at least 98% of pixels (measured: max 4.7e-6 end to end).
"""
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
from test_pallas_interpret import interpret_mode  # noqa: E402
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.ops import ao as AJ  # noqa: E402
from rtsdm_tpu.ops import rt_pallas as rp  # noqa: E402
from rtsdm_tpu.passes import svao_shift as PHJ  # noqa: E402
from rtsdm_tpu.passes.gbuffer import raster_gbuffer as gb_j  # noqa: E402
from rtsdm_tpu.passes.svao import SVAO as SVAO_J  # noqa: E402
from rtsdm_tpu.passes.svao import _normals_to_view as nv_j  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RC_J  # noqa: E402
from rtsdm_tpu.scene.procedural import cornell_box  # noqa: E402
from rtsdm_tpu.utils import math as MJ  # noqa: E402
from rtsdm_tpu_torch.ops import ao as A  # noqa: E402
from rtsdm_tpu_torch.passes import svao_shift as PH  # noqa: E402
from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer  # noqa: E402
from rtsdm_tpu_torch.passes.svao import SVAO, _normals_to_view  # noqa: E402
from rtsdm_tpu_torch.rendergraph.graph import RenderGraph  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402
from rtsdm_tpu_torch.utils.math import (encode_normal_2x16,  # noqa: E402
                                        normalize, transform_vector)

W = H = 64
PROPS = {"secondaryDepthMode": "StochasticDepth", "stochasticDepthImpl": "Ray",
         "radius": 0.5, "stochMapDivisor": 4, "stochMapGuardBand": 32,
         "exponent": 2.0, "sampleCount": 4, "stochSamples": 2}


def t(a):
    return torch.as_tensor(np.array(a))


def _sd_graph_on_pallas(pass_j, scene, ctx_w, ctx_h, inputs):
    """The reference's nested SD graph with the streaming Pallas trace in
    interpret mode (on the CPU the pass would take its XLA tier)."""
    g = pass_j._build_sd_graph()
    g.set_scene(scene)
    g.passes["StochasticDepthMap"].cfg["pallasStream"] = True
    ctx = RC_J(width=ctx_w, height=ctx_h, scene=scene,
               dictionary={"guardBand": 0})
    fake = [type("D", (), {"platform": "tpu"})()]

    @jax.jit
    def run(inputs):
        marked, _, _ = g.execute(ctx, {}, external_inputs=inputs)
        return marked["StochasticDepthMap.stochasticDepth"]

    with interpret_mode(rp), mock.patch.object(jax, "devices",
                                               lambda *a, **k: fake):
        return np.asarray(run(inputs))


def _gbuffer_on_pallas(scene):
    """The reference G-buffer through its Pallas raster and attribute
    fetch (interpret mode), the tier the headline benchmark runs. It runs
    op by op (jax.disable_jit): compiled as one program, XLA:CPU contracts
    a*b+c into fused multiply-adds in the triangle setup, which moves edge
    tests and depth in the last bit (tests/test_torch_raster.py); op by op
    every operation rounds on its own, as in PyTorch and in the CUDA
    kernels, and the raster agrees exactly."""
    from rtsdm_tpu.ops import raster as RJ
    from rtsdm_tpu.ops import raster_pallas as rpx
    fake = [type("D", (), {"platform": "tpu"})()]
    with interpret_mode(rpx), jax.disable_jit(), \
            mock.patch.object(RJ, "PALLAS_RASTER_MIN_TRIS", 0), \
            mock.patch.object(jax, "devices", lambda *a, **k: fake):
        return {k: np.asarray(v) for k, v in gb_j(scene, W, H).items()}


@pytest.fixture(scope="module")
def case():
    sj = cornell_box()
    cam = sj.camera
    g = _gbuffer_on_pallas(sj)
    lin = cam.linearize_depth(g["depth"])
    nv_in = MJ.encode_normal_2x16(MJ.normalize(
        MJ.transform_vector(cam.view_mat, g["faceNormalW"])))
    pj = SVAO_J(PROPS)
    pj.set_scene(sj)
    ctx = RC_J(width=W, height=H, scene=sj, dictionary={"guardBand": 0})
    cfg = pj._vao_cfg(ctx, (W, H))
    nv = nv_j(ctx, nv_in)
    # jitted like the benchmark's stages (one compile instead of
    # hundreds of eager op dispatches)
    p1 = jax.jit(lambda d, n: PHJ.svao_phase1_shift(
        cam, cfg, d, d, n, 0, "SingleDepth", "StochasticDepth"))(lin, nv)
    sd_w, sd_h = pj._stoch_map_size((W, H))
    sd_inputs = {"StochasticDepthMap.linearZ": lin,
                 "StochasticDepthMap.depthMap": g["depth"],
                 "StochasticDepthMap.rayMin": p1["ray_min"],
                 "StochasticDepthMap.rayMax": p1["ray_max"]}
    sd_map = _sd_graph_on_pallas(pj, sj, sd_w, sd_h, sd_inputs)
    delta = jax.jit(lambda d, n, s, m: PHJ.svao_phase2_shift(
        cam, cfg, d, d, n, s, m, "SingleDepth", divisor=4))(
            lin, nv, p1["stencil"], jnp.asarray(sd_map))
    ao = jnp.where(p1["stencil"] != 0, AJ.finalize(cfg, p1["ao_raw"] + delta),
                   AJ.finalize(cfg, p1["ao_raw"]))
    ref = dict(g={k: np.asarray(v) for k, v in g.items()}, lin=lin,
               nv_in=np.asarray(nv_in), nv=np.asarray(nv),
               p1={k: np.asarray(v) for k, v in p1.items()},
               sd_map=sd_map, delta=np.asarray(delta), ao=np.asarray(ao))

    st = carry(sj)
    pt = SVAO(PROPS)
    pt.set_scene(st)
    ctx_t = RenderContext(width=W, height=H, scene=st,
                          dictionary={"guardBand": 0})
    return dict(sj=sj, st=st, cfg_t=pt._vao_cfg(ctx_t, (W, H)), pass_t=pt,
                ctx_t=ctx_t, ref=ref)


def _port_frame(st, pass_t, ctx_t):
    """The port's main path, as a user calls it."""
    cam = st.camera
    g = raster_gbuffer(st, W, H)
    lin = cam.linearize_depth(g["depth"])
    packed = encode_normal_2x16(normalize(
        transform_vector(cam.view_mat, g["faceNormalW"])))
    out, _ = pass_t.execute(ctx_t, {"gbufferDepth": g["depth"], "depth": lin,
                                    "normals": packed})
    return g, out


def test_gbuffer_matches_reference(case):
    """Visibility, depth and the flat channels are bit-exact; the
    barycentrics and the channels interpolated with them agree to 1e-5
    (measured max 3.3e-6)."""
    ref = case["ref"]["g"]
    got = {k: v.numpy() for k, v in raster_gbuffer(case["st"], W, H).items()}
    for k in ("tri_id", "depth", "mtlData", "faceNormalW", "texC"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("bary", "posW", "normW", "mvec"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_phase1_matches_reference(case):
    ref = case["ref"]
    cam = case["st"].camera
    nv = _normals_to_view(case["ctx_t"], t(ref["nv_in"].view(np.int32)))
    np.testing.assert_array_equal(nv.numpy(), ref["nv"])
    got = PH.svao_phase1_shift(cam, case["cfg_t"], t(ref["lin"]), nv, 0)
    np.testing.assert_array_equal(got["stencil"].numpy(),
                                  ref["p1"]["stencil"].astype(np.int32))
    assert (ref["p1"]["stencil"] != 0).any()
    # the jitted reference fuses the interval arithmetic: 1 ulp
    np.testing.assert_allclose(got["ray_min"].numpy(), ref["p1"]["ray_min"],
                               rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(got["ray_max"].numpy(), ref["p1"]["ray_max"],
                               rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(got["ao_raw"].numpy(), ref["p1"]["ao_raw"],
                               atol=1e-5, rtol=0)


def test_sd_pass_matches_reference(case):
    """The port's nested SD graph on the reference's phase-1 intervals:
    same empty slots; same depths wherever a texel has fewer than k hits
    (with k hits or more the kept subset depends on the hash keys, see
    tests/test_torch_sd_trace.py)."""
    ref = case["ref"]
    pt = case["pass_t"]
    g = pt._build_sd_graph()
    g.set_scene(case["st"])
    sd_w, sd_h = pt._stoch_map_size((W, H))
    marked, _, _ = g.execute(
        RenderContext(width=sd_w, height=sd_h, scene=case["st"]), {},
        external_inputs={"StochasticDepthMap.linearZ": t(ref["lin"]),
                         "StochasticDepthMap.rayMin": t(ref["p1"]["ray_min"]),
                         "StochasticDepthMap.rayMax": t(ref["p1"]["ray_max"])})
    got = marked["StochasticDepthMap.stochasticDepth"].numpy()
    want = ref["sd_map"]
    assert got.shape == want.shape == (sd_h, sd_w, 2)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    assert (want < 1.0).any()
    free = (want < 1.0).sum(-1) < 2

    def codes(d):  # the 16-bit depth codes (the jitted reference decodes
        return np.sort(np.round(d * 65535.0), -1)[free]  # within 1 ulp)

    np.testing.assert_array_equal(codes(got), codes(want))


def test_phase2_matches_reference(case):
    ref = case["ref"]
    nv = t(ref["nv"])
    got = PH.svao_phase2_shift(case["st"].camera, case["cfg_t"],
                               t(ref["lin"]), nv,
                               t(ref["p1"]["stencil"].astype(np.int32)),
                               t(ref["sd_map"]))
    assert np.abs(ref["delta"]).max() > 0.0
    np.testing.assert_allclose(got.numpy(), ref["delta"], atol=1e-5, rtol=0)


def _check_ao_field(ao):
    assert ao.shape == (H, W) and np.isfinite(ao).all()
    assert 0.0 <= ao.min() and ao.max() <= 1.0 and ao.min() < 0.9


def test_slice_from_gbuffer_matches_reference(case):
    """linearize -> packed view normals -> SVAO.execute (phase 1, nested SD
    graph, phase 2, finalize) on the reference G-buffer's depth and face
    normals: the reference's cross-tier bound."""
    ref, st = case["ref"], case["st"]
    cam = st.camera
    depth = t(ref["g"]["depth"])
    packed = encode_normal_2x16(normalize(transform_vector(
        cam.view_mat, t(ref["g"]["faceNormalW"]))))
    out, _ = case["pass_t"].execute(case["ctx_t"], {
        "gbufferDepth": depth, "depth": cam.linearize_depth(depth),
        "normals": packed})
    ao = out["ao"].numpy()
    _check_ao_field(ao)
    diff = np.abs(ao - ref["ao"])
    assert (diff < 2e-2).all(), diff.max()
    assert (diff < 1e-4).mean() >= 0.98


def test_whole_slice_ao_matches_reference(case):
    """End to end, the port's own G-buffer included: the reference's
    cross-tier bound."""
    g, out = _port_frame(case["st"], case["pass_t"], case["ctx_t"])
    ao = out["ao"].numpy()
    _check_ao_field(ao)
    np.testing.assert_array_equal(g["tri_id"].numpy(),
                                  case["ref"]["g"]["tri_id"])
    diff = np.abs(ao - case["ref"]["ao"])
    assert (diff < 2e-2).all(), diff.max()
    assert (diff < 1e-4).mean() >= 0.98


def test_render_graph_runs_slice_and_prunes(case):
    """The slice as a render graph: G-buffer -> LinearizeDepth /
    CompressNormals -> SVAO gives the direct path's AO; a pass feeding no
    marked output never runs."""
    st = case["st"]
    graph = RenderGraph("svao")
    graph.create_pass("GBuffer", "GBufferRaster", {})
    graph.create_pass("Lin", "LinearizeDepth", {})
    graph.create_pass("Nrm", "CompressNormals", {})
    graph.create_pass("SVAO", "SVAO", PROPS)
    dead = graph.create_pass("Dead", "LinearizeDepth", {})
    for src, dst in (("GBuffer.depth", "Lin.depth"),
                     ("GBuffer.faceNormalW", "Nrm.normalW"),
                     ("GBuffer.depth", "SVAO.gbufferDepth"),
                     ("Lin.linearDepth", "SVAO.depth"),
                     ("Nrm.normalOut", "SVAO.normals"),
                     ("GBuffer.depth", "Dead.depth")):
        graph.add_edge(src, dst)
    graph.mark_output("SVAO.ao")
    graph.set_scene(st)
    ran = []
    dead.execute = lambda *a, **k: ran.append(1)
    marked, _, _ = graph.execute(RenderContext(width=W, height=H, scene=st))
    assert not ran
    _, out = _port_frame(st, case["pass_t"], case["ctx_t"])
    assert torch.equal(marked["SVAO.ao"], out["ao"])


@pytest.mark.parametrize("props", [
    {"primaryDepthMode": "DualDepth"}, {"secondaryDepthMode": "Raytraced"},
    {"stochasticDepthImpl": "Raster"}, {"kernel": "HBAO"},
    {"samplingMode": "gather"}, {"dualAO": True}])
def test_unported_svao_modes_raise(props):
    with pytest.raises(NotImplementedError):
        SVAO({**PROPS, **props})


@pytest.mark.parametrize("sd_props", [{"Implementation": "coverage"},
                                      {"MaxCount": 8}])
def test_unported_sd_modes_raise(case, sd_props):
    from rtsdm_tpu_torch.passes.stochastic_depth import StochasticDepthMapRT
    p = StochasticDepthMapRT(sd_props)
    z = torch.zeros((8, 8))
    with pytest.raises(NotImplementedError):
        p.execute(RenderContext(width=8, height=8, scene=case["st"]),
                  {"linearZ": z, "rayMin": z, "rayMax": z})


def test_finalize_and_dilation_match_reference():
    from rtsdm_tpu.passes.svao import _dilate as dilate_j
    from rtsdm_tpu_torch.passes.svao import _dilate
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 5, (37, 29)).astype(np.float32)
    for op_t, op_j, fill in ((torch.minimum, jnp.minimum, 3e38),
                             (torch.maximum, jnp.maximum, 0.0)):
        np.testing.assert_array_equal(
            _dilate(t(a), 3, op_t, fill).numpy(),
            np.asarray(dilate_j(jnp.asarray(a), 3, op_j, fill)))
    cfg_j = AJ.VAOConfig(exponent=2.0)
    x = rng.uniform(-0.5, 1.5, 999).astype(np.float32)
    # x ** 2.0: PyTorch squares, XLA may take another pow path (1 ulp)
    np.testing.assert_allclose(A.finalize(A.VAOConfig(), t(x)).numpy(),
                               np.asarray(AJ.finalize(cfg_j, jnp.asarray(x))),
                               rtol=2.5e-7, atol=0)
