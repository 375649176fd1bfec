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

The modes DualDepth (a second depth layer: the linear depth plus a seeded
offset), secondary SingleDepth and dualAO are held phase by phase and
through SVAO.execute against the same reference functions, with the
bounds stated in each test; so are the reference modes: gather sampling
(svao_phase1 / svao_phase2), the HBAO kernel in shift mode, secondary
DualDepth and the Raytraced secondary mode (_phase2_raytraced over the
brute-force interval query, also with a ray budget too small for its
pairs).
"""
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

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
    {"stochMapDivisor": 3}, {"stochasticDepthImpl": "Coverage"}])
def test_unported_svao_modes_raise(props):
    with pytest.raises(NotImplementedError):
        SVAO({**PROPS, **props})


@pytest.mark.parametrize("sd_props", [
    {"usePallas": False}, {"Implementation": "coverage", "SampleCount": 6},
    {"StoreNormals": True}, {"depthFormat": "R16Unorm"}])
def test_unported_sd_modes_raise(case, sd_props):
    """The reference's XLA tier (usePallas=False, and coverage above
    COVERAGE_MAX_K samples) and the keys it ignores on the ported tiers
    raise at render time instead of taking another tier."""
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


@pytest.fixture(scope="module")
def debug_case(case):
    """The reference's SVAO.execute with a debug pixel selected (a
    stenciled one, so the SD map is read there), on its accelerator path
    (the nested trace on the Pallas tier), with its three heavy stages
    replaced by their results in `case` (phase 1, the trace's decoded SD
    map, phase 2; computed by the reference's own functions): its own glue
    then publishes SD_MAP, maps the pixel into the nested graph and prints
    its taps. And the port's SVAO.execute, run in full, on the same inputs
    and pixel."""
    import rtsdm_tpu.passes.svao_shift as shift_j
    sj, st, ref = case["sj"], case["st"], case["ref"]
    ys, xs = np.nonzero(ref["p1"]["stencil"])
    px, py = int(xs[len(xs) // 2]), int(ys[len(ys) // 2])
    pj = SVAO_J(PROPS)
    pj.set_scene(sj)
    pj._sd_graph = pj._build_sd_graph()
    pj._sd_graph.set_scene(sj)
    pj._sd_graph.passes["StochasticDepthMap"].cfg["pallasStream"] = True
    ctx = RC_J(width=W, height=H, scene=sj, dictionary={"guardBand": 0},
               pixel_debug=(px, py))
    k = ref["sd_map"].shape[-1]
    fake = [type("D", (), {"platform": "tpu"})()]
    with mock.patch.object(jax, "devices", lambda *a, **kw: fake), \
            mock.patch.object(shift_j, "svao_phase1_shift", lambda *a, **kw:
                              {n: jnp.asarray(v)
                               for n, v in ref["p1"].items()}), \
            mock.patch.object(shift_j, "svao_phase2_shift", lambda *a, **kw:
                              jnp.asarray(ref["delta"])), \
            mock.patch.object(rp, "sd_trace_pallas_stream", lambda *a, **kw:
                              jnp.zeros((a[2].shape[0], k), jnp.int32)), \
            mock.patch.object(rp, "decode_packed", lambda *a, **kw:
                              jnp.asarray(ref["sd_map"]).reshape(-1, k)):
        pj.execute(ctx, {n: jnp.asarray(v) for n, v in (
            ("gbufferDepth", ref["g"]["depth"]), ("depth", ref["lin"]),
            ("normals", ref["nv_in"]))})
    want = dict(sd_map=np.asarray(ctx.dictionary["SD_MAP"]),
                names=[n for n, _ in ctx.debug_log],
                values=[np.asarray(v) for _, v in ctx.debug_log])

    pt = SVAO(PROPS)
    pt.set_scene(st)
    ctx_t = RenderContext(width=W, height=H, scene=st,
                          dictionary={"guardBand": 0}, pixel_debug=(px, py))
    pt.execute(ctx_t, {"gbufferDepth": t(ref["g"]["depth"]),
                       "depth": t(ref["lin"]),
                       "normals": t(ref["nv_in"].view(np.int32))})
    return dict(want=want, ctx=ctx_t)


def test_svao_publishes_its_sd_map(debug_case):
    """SVAO stores the nested graph's SD map as ctx.dictionary["SD_MAP"],
    as the reference does (rtsdm_tpu/passes/svao.py:247): the same shape,
    the same empty slots, and the same depth codes wherever a texel has
    fewer than k hits (test_sd_pass_matches_reference's rule)."""
    got = debug_case["ctx"].dictionary["SD_MAP"].numpy()
    want = debug_case["want"]["sd_map"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    free = (want < 1.0).sum(-1) < want.shape[-1]
    assert free.any() and (want < 1.0).any()

    def codes(d):
        return np.sort(np.round(d * 65535.0), -1)[free]

    np.testing.assert_array_equal(codes(got), codes(want))


def test_svao_debug_print_at_one_pixel(debug_case):
    """ctx.debug_print with a pixel selected: the reference's taps in its
    order (the nested SD pass's at the pixel's SD texel, then SVAO's),
    with their values; the stencil exactly, the SD depths as 16-bit codes,
    the intervals to 1 ulp and the AO terms to 1e-5 (the bounds of the
    stage tests above)."""
    want = debug_case["want"]
    log = debug_case["ctx"].debug_log
    assert [n for n, _ in log] == want["names"] == [
        "sdrt.stochasticDepth", "sdrt.rayMin", "sdrt.rayMax", "svao.ao_raw",
        "svao.delta", "svao.stencil", "svao.ao"]
    for (name, got), w in zip(log, want["values"]):
        got = got.numpy()
        assert got.shape == w.shape, name
        if name == "svao.stencil":
            np.testing.assert_array_equal(got, w.astype(np.int32))
        elif name == "sdrt.stochasticDepth":
            np.testing.assert_array_equal(np.round(got * 65535.0),
                                          np.round(w * 65535.0))
        elif name.startswith("sdrt.ray"):
            np.testing.assert_allclose(got, w, rtol=2.5e-7, atol=0)
        else:
            np.testing.assert_allclose(got, w, atol=1e-5, rtol=0, err_msg=name)
    assert int(log[5][1]) != 0                    # a stenciled pixel


def test_debug_print_is_a_no_op_without_a_pixel():
    """No pixel selected: nothing is logged (and nothing is read back)."""
    ctx = RenderContext(width=4, height=4)
    ctx.debug_print("x", torch.zeros((4, 4)))
    assert ctx.debug_log == []
    ctx.pixel_debug = (9, -3)                     # clamped to the array
    ctx.debug_print("x", torch.arange(16.0).reshape(4, 4))
    ctx.debug_print("scalar", torch.zeros(3))      # fewer than 2 dims
    assert [(n, float(v)) for n, v in ctx.debug_log] == [("x", 3.0)]


# --- the SVAO modes: DualDepth primary depth, SingleDepth secondary depth
# (phase 1 alone) and dualAO (bright and dark channels) ----------------------

MODES = {"DualDepth": {"primaryDepthMode": "DualDepth"},
         "SingleDepth": {"secondaryDepthMode": "SingleDepth"},
         "dualAO": {"dualAO": True}}


def _mode_args(props):
    return dict(primary=props.get("primaryDepthMode", "SingleDepth"),
                secondary=props.get("secondaryDepthMode", "StochasticDepth"))


@pytest.fixture(scope="module")
def depth2(case):
    """A second depth layer behind the first: the linear depth plus a
    seeded offset in [0.05, 2]."""
    rng = np.random.default_rng(10)
    lin = np.asarray(case["ref"]["lin"])
    return (lin + rng.uniform(0.05, 2.0, lin.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def mode_refs(case, depth2):
    """Per mode: the JAX package's phase 1 (jitted, as in `case`) and its
    configuration, and the port's configuration."""
    sj, st, ref = case["sj"], case["st"], case["ref"]
    out = {}
    for mode, extra in MODES.items():
        props = {**PROPS, **extra}
        pj = SVAO_J(props)
        cfg = pj._vao_cfg(RC_J(width=W, height=H, scene=sj), (W, H))
        a = _mode_args(props)
        p1 = jax.jit(lambda d, d2, n, cfg=cfg, a=a: PHJ.svao_phase1_shift(
            sj.camera, cfg, d, d2, n, 0, a["primary"], a["secondary"]))(
                ref["lin"], depth2, ref["nv"])
        cfg_t = SVAO(props)._vao_cfg(RenderContext(width=W, height=H,
                                                   scene=st), (W, H))
        out[mode] = dict(props=props, cfg=cfg, cfg_t=cfg_t,
                         p1={k: np.asarray(v) for k, v in p1.items()})
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_phase1_modes_match_reference(case, depth2, mode_refs, mode):
    """Phase 1 under DualDepth (both layers through one K3 call), secondary
    SingleDepth (no intervals: the empty grids; off-stencil visibility on
    the dark channel) and dualAO ([H, W, 2]): the stencil bit-exact, the
    raw AO to 1e-5 and the SD-grid intervals to 1 ulp, the bounds of
    test_phase1_matches_reference (measured: raw AO within 2.9e-6, the
    intervals within 2.3e-7 relative)."""
    ref, r = case["ref"], mode_refs[mode]
    got = PH.svao_phase1_shift(case["st"].camera, r["cfg_t"], t(ref["lin"]),
                               t(ref["nv"]), 0, depth2=t(depth2),
                               **_mode_args(r["props"]))
    want = r["p1"]
    np.testing.assert_array_equal(got["stencil"].numpy(),
                                  want["stencil"].astype(np.int32))
    assert (want["stencil"] != 0).any()
    assert got["ao_raw"].shape == want["ao_raw"].shape == (
        (H, W, 2) if mode == "dualAO" else (H, W))
    np.testing.assert_allclose(got["ao_raw"].numpy(), want["ao_raw"],
                               atol=1e-5, rtol=0)
    for k in ("ray_min", "ray_max"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2.5e-7,
                                   atol=0, err_msg=k)
    if mode == "SingleDepth":
        assert r["cfg_t"].sd_guard == r["cfg"].sd_guard == 0
        assert (want["ray_max"] == 0).all() and (want["ray_min"] > 1e38).all()


def test_dual_depth_reads_the_second_layer(case, depth2, mode_refs):
    """DualDepth's phase 1 is not SingleDepth's: where the first layer's
    sample needs a ray, the second layer's visibility is taken."""
    assert not np.array_equal(mode_refs["DualDepth"]["p1"]["ao_raw"],
                              np.asarray(case["ref"]["p1"]["ao_raw"]))


@pytest.mark.parametrize("mode", ["DualDepth", "dualAO"])
def test_phase2_modes_match_reference(case, depth2, mode_refs, mode):
    """Phase 2 under DualDepth (the primary visibility from depth2's layer)
    and dualAO (the correction stacked with a zero dark channel) on the
    reference's SD map and this mode's stencil: within 1e-5, the bound of
    test_phase2_matches_reference (measured: 2.6e-6 and 3.0e-6)."""
    ref, r = case["ref"], mode_refs[mode]
    a = _mode_args(r["props"])
    stencil = r["p1"]["stencil"]
    want = np.asarray(jax.jit(lambda d, d2, n, s, m: PHJ.svao_phase2_shift(
        case["sj"].camera, r["cfg"], d, d2, n, s, m, a["primary"],
        divisor=4))(ref["lin"], depth2, ref["nv"], stencil,
                    jnp.asarray(ref["sd_map"])))
    got = PH.svao_phase2_shift(case["st"].camera, r["cfg_t"], t(ref["lin"]),
                               t(ref["nv"]), t(stencil.astype(np.int32)),
                               t(ref["sd_map"]), depth2=t(depth2),
                               primary=a["primary"]).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_svao_execute_modes_match_reference(case, depth2, mode):
    """SVAO.execute in each mode against the JAX package's SVAO.execute on
    the same inputs (its nested SD graph through the streaming Pallas trace
    in interpret mode, its fetches through the XLA tier): the stencil
    bit-exact and the AO within 1e-5 in every mode (measured 4.7e-6 in
    each)."""
    import rtsdm_tpu.passes.svao_shift as shift_j
    sj, st, ref = case["sj"], case["st"], case["ref"]
    props = {**PROPS, **MODES[mode]}
    pj = SVAO_J(props)
    pj.set_scene(sj)
    pj._sd_graph = pj._build_sd_graph()
    pj._sd_graph.set_scene(sj)
    pj._sd_graph.passes["StochasticDepthMap"].cfg["pallasStream"] = True
    ctx = RC_J(width=W, height=H, scene=sj, dictionary={"guardBand": 0})
    inputs = {"gbufferDepth": ref["g"]["depth"], "depth": ref["lin"],
              "depth2": depth2, "normals": ref["nv_in"]}
    fake = [type("D", (), {"platform": "tpu"})()]
    with interpret_mode(rp), \
            mock.patch.object(jax, "devices", lambda *a, **kw: fake), \
            mock.patch.object(shift_j, "FUSED_FETCH", "off"):
        want = jax.jit(lambda i: pj.execute(ctx, i)[0])(
            {k: jnp.asarray(v) for k, v in inputs.items()})
    want = {k: np.asarray(v) for k, v in want.items()}

    pt = SVAO(props)
    pt.set_scene(st)
    ctx_t = RenderContext(width=W, height=H, scene=st,
                          dictionary={"guardBand": 0})
    got, _ = pt.execute(ctx_t, {
        k: t(v.view(np.int32) if k == "normals" else v)
        for k, v in inputs.items()})
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["stencil"],
                                  want["stencil"].astype(np.int32))
    ao, ao_want = got["ao"], want["ao"]
    assert ao.shape == ao_want.shape == ((H, W, 2) if mode == "dualAO"
                                         else (H, W))
    assert np.isfinite(ao).all() and 0.0 <= ao.min() and ao.max() <= 1.0
    np.testing.assert_allclose(ao, ao_want, atol=1e-5, rtol=0)
    if mode == "SingleDepth":
        assert "SD_MAP" not in ctx_t.dictionary
    else:
        assert ctx_t.dictionary["SD_MAP"].shape[-1] == PROPS["stochSamples"]
    if mode == "dualAO":
        assert (ao[..., 1] <= ao[..., 0] + 1e-7).all()  # bright >= dark


@pytest.mark.parametrize("mode,unused", [
    ("SingleDepth", ("depth2",)), ("DualDepth", ()), ("dualAO", ("depth2",))])
def test_unused_inputs_per_mode(mode, unused):
    """depth2 is read only under DualDepth, so only then does the graph
    keep the DepthPeeling chain that feeds it."""
    ctx = RenderContext(width=W, height=H)
    assert tuple(SVAO({**PROPS, **MODES[mode]}).unused_inputs(ctx)) == unused
    assert tuple(SVAO_J({**PROPS, **MODES[mode]}).unused_inputs(
        RC_J(width=W, height=H))) == unused


# --- the reference modes: gather sampling, the HBAO kernel, secondary
# DualDepth and Raytraced ----------------------------------------------------

REF_MODES = {"gather": {"samplingMode": "gather"},
             "HBAO": {"kernel": "HBAO"},
             "Raytraced": {"secondaryDepthMode": "Raytraced"},
             "secondaryDualDepth": {"secondaryDepthMode": "DualDepth"}}


def _cfgs(case, props):
    """(the JAX package's VAOConfig, the port's) for `props`."""
    cfg = SVAO_J(props)._vao_cfg(RC_J(width=W, height=H, scene=case["sj"]),
                                 (W, H))
    cfg_t = SVAO(props)._vao_cfg(RenderContext(width=W, height=H,
                                               scene=case["st"]), (W, H))
    return cfg, cfg_t


@pytest.mark.parametrize("primary", ["SingleDepth", "DualDepth"])
def test_gather_phase1_matches_reference(case, depth2, primary):
    """svao_phase1 (per-pixel gathers) against the JAX package's: the
    stencil bit-exact, the raw AO within 1e-5 and the SD-grid intervals
    within 1 ulp, the bounds of the shift-mode phase 1."""
    from rtsdm_tpu.passes.svao import svao_phase1 as p1_j
    from rtsdm_tpu_torch.passes.svao import svao_phase1
    ref = case["ref"]
    cfg, cfg_t = _cfgs(case, {**PROPS, "samplingMode": "gather",
                              "primaryDepthMode": primary})
    want = jax.jit(lambda d, d2, n: p1_j(
        case["sj"].camera, cfg, d, d2, n, 0, primary, "StochasticDepth"))(
            ref["lin"], depth2, ref["nv"])
    got = svao_phase1(case["st"].camera, cfg_t, t(ref["lin"]), t(ref["nv"]),
                      0, depth2=t(depth2), primary=primary)
    np.testing.assert_array_equal(got["stencil"].numpy(),
                                  np.asarray(want["stencil"]).astype(np.int32))
    assert (np.asarray(want["stencil"]) != 0).any()
    np.testing.assert_allclose(got["ao_raw"].numpy(), want["ao_raw"],
                               atol=1e-5, rtol=0)
    for k in ("ray_min", "ray_max"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2.5e-7,
                                   atol=0, err_msg=k)


def test_gather_phase2_matches_reference(case):
    """svao_phase2's StochasticDepth branch (an sd_map[y, x] gather with
    the per-texel jitter) on the reference's SD map and the shift-mode
    stencil: within 1e-5, the bound of the shift-mode phase 2."""
    from rtsdm_tpu.passes.svao import svao_phase2 as p2_j
    from rtsdm_tpu_torch.passes.svao import svao_phase2
    ref = case["ref"]
    cfg, cfg_t = _cfgs(case, {**PROPS, "samplingMode": "gather"})
    stencil = ref["p1"]["stencil"]
    want = np.asarray(jax.jit(lambda d, n, s, m: p2_j(
        case["sj"], case["sj"].camera, cfg, d, d, n, s, m, "SingleDepth",
        "StochasticDepth"))(ref["lin"], ref["nv"], stencil,
                            jnp.asarray(ref["sd_map"])))
    got = svao_phase2(case["st"], case["st"].camera, cfg_t, t(ref["lin"]),
                      t(ref["lin"]), t(ref["nv"]),
                      t(stencil.astype(np.int32)), t(ref["sd_map"]),
                      "SingleDepth", "StochasticDepth").numpy()
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fraction", [0.5, 0.01])
def test_phase2_raytraced_matches_reference(case, fraction):
    """_phase2_raytraced through svao_phase2: the brute-force interval
    query with cull None and the alpha test, on the Raytraced mode's
    stencil at fraction 0.5, and at 0.01 on every direction of every pixel
    (16,384 pairs against a budget of 1,024 rays, so the pairs past it keep
    their raster visibility): within 1e-5 in both."""
    from rtsdm_tpu.passes.svao import svao_phase2 as p2_j
    from rtsdm_tpu_torch.ops import rt
    from rtsdm_tpu_torch.passes import svao as SV
    ref = case["ref"]
    props = {**PROPS, "secondaryDepthMode": "Raytraced",
             "maxRayBudgetFraction": fraction}
    cfg, cfg_t = _cfgs(case, props)
    p1 = PH.svao_phase1_shift(case["st"].camera, cfg_t, t(ref["lin"]),
                              t(ref["nv"]), 0, secondary="Raytraced")
    stencil = p1["stencil"].numpy()
    if fraction < 0.1:
        stencil = np.full_like(stencil, (1 << PROPS["sampleCount"]) - 1)
    n_bits = int(np.unpackbits(stencil.view(np.uint8)).sum())
    want = np.asarray(jax.jit(lambda d, n, s: p2_j(
        case["sj"], case["sj"].camera, cfg, d, d, n, s, None, "SingleDepth",
        "Raytraced", cull="None", ray_budget_fraction=fraction))(
            ref["lin"], ref["nv"], stencil.astype(np.uint32)))
    traced = []
    real = rt.vao_interval_query

    def query(scene, origins, *a, **kw):
        traced.append(origins.shape[0])
        return real(scene, origins, *a, **kw)

    with mock.patch.object(rt, "vao_interval_query", query):
        got = SV.svao_phase2(case["st"], case["st"].camera, cfg_t,
                             t(ref["lin"]), t(ref["lin"]), t(ref["nv"]),
                             t(stencil), None, "SingleDepth", "Raytraced",
                             cull="None",
                             ray_budget_fraction=fraction).numpy()
    budget = SV.ray_budget(W * H * PROPS["sampleCount"], fraction)
    assert traced == [min(n_bits, budget)]
    if fraction < 0.1:
        assert n_bits > budget
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# The HBAO kernel's |v - p|^2, expanded in the fetched depth z as
# (z qa + qb) z + |p|^2 (the JAX package's depth-affine form, kept),
# cancels where the sample lies close to the pixel: the JAX package's own
# jitted phase 1 (XLA:CPU contracts multiply-adds) is 1.1e-4 from its op
# by op evaluation, and a jitted requireRay flips stencil bits. So the HBAO
# references run op by op (jax.disable_jit), every operation rounded on
# its own as in PyTorch; the port is within 1.6e-5 of them (measured: sin,
# cos and sqrt round differently from XLA's and the cancellation
# amplifies it).
HBAO_ATOL = 5e-5


def test_hbao_kernel_shift_phases_match_reference(case, depth2):
    """Shift-mode phases 1 and 2 with the HBAO kernel (its ring tables
    through K3's and K4's plain versions, its visibility and requireRay,
    the max over SD layers) under DualDepth, against the JAX package op by
    op (HBAO_ATOL): the stencil bit-exact, the intervals to 1 ulp, the raw
    AO and the correction within HBAO_ATOL."""
    ref = case["ref"]
    props = {**PROPS, "kernel": "HBAO", "primaryDepthMode": "DualDepth"}
    cfg, cfg_t = _cfgs(case, props)
    assert cfg_t.kernel == cfg.kernel == AJ.AO_KERNEL_HBAO
    with jax.disable_jit():
        want = PHJ.svao_phase1_shift(
            case["sj"].camera, cfg, jnp.asarray(ref["lin"]),
            jnp.asarray(depth2), jnp.asarray(ref["nv"]), 0, "DualDepth",
            "StochasticDepth")
    got = PH.svao_phase1_shift(case["st"].camera, cfg_t, t(ref["lin"]),
                               t(ref["nv"]), 0, depth2=t(depth2),
                               primary="DualDepth")
    stencil = np.asarray(want["stencil"])
    np.testing.assert_array_equal(got["stencil"].numpy(),
                                  stencil.astype(np.int32))
    assert (stencil != 0).any()
    np.testing.assert_allclose(got["ao_raw"].numpy(), want["ao_raw"],
                               atol=HBAO_ATOL, rtol=0)
    for k in ("ray_min", "ray_max"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2.5e-7,
                                   atol=0, err_msg=k)
    with jax.disable_jit():
        d_want = np.asarray(PHJ.svao_phase2_shift(
            case["sj"].camera, cfg, jnp.asarray(ref["lin"]),
            jnp.asarray(depth2), jnp.asarray(ref["nv"]),
            jnp.asarray(stencil), jnp.asarray(ref["sd_map"]), "DualDepth",
            divisor=4))
    d_got = PH.svao_phase2_shift(case["st"].camera, cfg_t, t(ref["lin"]),
                                 t(ref["nv"]), t(stencil.astype(np.int32)),
                                 t(ref["sd_map"]), depth2=t(depth2),
                                 primary="DualDepth").numpy()
    assert np.abs(d_want).max() > 0.0
    np.testing.assert_allclose(d_got, d_want, atol=HBAO_ATOL, rtol=0)


@pytest.mark.parametrize("mode", sorted(REF_MODES))
def test_svao_execute_reference_modes_match_reference(case, depth2, mode):
    """SVAO.execute in each reference mode against the JAX package's
    SVAO.execute on the same inputs (as test_svao_execute_modes_match_
    reference; under HBAO op by op, see HBAO_ATOL): the stencil bit-exact
    and the AO within 1e-5 (under HBAO 4 x HBAO_ATOL, finalize's
    clamp(1 - 2 raw)^2 amplifying the raw AO's: measured 5.8e-5).
    Secondary DualDepth adds no correction in either package."""
    import rtsdm_tpu.passes.svao_shift as shift_j
    sj, st, ref = case["sj"], case["st"], case["ref"]
    props = {**PROPS, **REF_MODES[mode]}
    pj = SVAO_J(props)
    pj.set_scene(sj)
    pj._sd_graph = pj._build_sd_graph()
    pj._sd_graph.set_scene(sj)
    pj._sd_graph.passes["StochasticDepthMap"].cfg["pallasStream"] = True
    ctx = RC_J(width=W, height=H, scene=sj, dictionary={"guardBand": 0})
    inputs = {"gbufferDepth": ref["g"]["depth"], "depth": ref["lin"],
              "depth2": depth2, "normals": ref["nv_in"]}
    fake = [type("D", (), {"platform": "tpu"})()]
    args = {k: jnp.asarray(v) for k, v in inputs.items()}
    with interpret_mode(rp), \
            mock.patch.object(jax, "devices", lambda *a, **kw: fake), \
            mock.patch.object(shift_j, "FUSED_FETCH", "off"):
        if mode == "HBAO":
            with jax.disable_jit():
                want = pj.execute(ctx, args)[0]
        else:
            want = jax.jit(lambda i: pj.execute(ctx, i)[0])(args)
    want = {k: np.asarray(v) for k, v in want.items()}

    pt = SVAO(props)
    pt.set_scene(st)
    ctx_t = RenderContext(width=W, height=H, scene=st,
                          dictionary={"guardBand": 0})
    got, _ = pt.execute(ctx_t, {
        k: t(v.view(np.int32) if k == "normals" else v)
        for k, v in inputs.items()})
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["stencil"],
                                  want["stencil"].astype(np.int32))
    assert (want["stencil"] != 0).any()
    ao = got["ao"]
    assert ao.shape == (H, W) and np.isfinite(ao).all()
    assert 0.0 <= ao.min() and ao.max() <= 1.0
    # finalize's clamp(1 - 2 raw)^2 amplifies HBAO's raw AO up to 4x
    np.testing.assert_allclose(ao, want["ao"], atol=4 * HBAO_ATOL
                               if mode == "HBAO" else 1e-5, rtol=0)
    assert ("SD_MAP" in ctx_t.dictionary) == (
        props["secondaryDepthMode"] == "StochasticDepth")


def test_svao_evaluates_its_transcendentals_on_host_tables():
    """The card rounds sin, cos and exp otherwise than the CPU in the last
    bit, and SVAO's stencil, ray intervals and SD-map keys amplify such
    bits (the substituted hold of scripts/SVAO_small.py read 1.4e-6 on the
    card, an H100 80GB HBM3, against 6.0e-15 on the CPU until they went).
    So the shift phases take the dither rotation's sin and cos and the
    shift radii's exp from tables evaluated on the host, and the camera is
    evaluated on the host too: in a frame of scripts/SVAO_small.py, SVAO
    (its nested SD pass included) calls these functions on no tensor of
    more than 32 entries (the tables)."""
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    root = Path(__file__).resolve().parents[1]
    m = Renderer(48, 48, device="cpu")
    run_script(str(root / "scripts" / "SVAO_small.py"), m)
    m.loadScene("CornellBox")
    m.clock.pause()
    A.dither_rotation_for.cache_clear()
    sizes = []
    in_svao = []

    def watched(fn):
        def call(x, *a, **k):
            if in_svao:
                sizes.append(x.numel())
            return fn(x, *a, **k)
        return call

    real = SVAO.execute

    def execute(self, *a, **k):
        in_svao.append(True)
        try:
            return real(self, *a, **k)
        finally:
            in_svao.pop()

    with mock.patch.multiple(torch, **{f: watched(getattr(torch, f))
                                       for f in ("sin", "cos", "exp", "tan",
                                                 "arctan")}), \
            mock.patch.object(SVAO, "execute", execute):
        m.renderFrame()
    assert sizes and max(sizes) <= 32
