"""BASELINE config 2's raster stochastic depth map in rtsdm_tpu_torch
against rtsdm_tpu on the CPU: the stratified coverage tables and mask, the
fragment hash, K9's plain version, the StochasticDepthMap pass, and
scripts/SVAO_small.py with stochasticDepthImpl 'Raster' through the port's
harness.

References. The port follows the Pallas tier (raster_stochastic_pallas, run
here in interpret mode) at every triangle count, as K1 follows
rasterize_pallas. On the CPU the reference package takes its XLA tier
instead (passes/stochastic_depth.py:282-291), whose fragment hash is
another one (hash3; tests/test_pallas_interpret.py:310-343), so the pass
and the graph are held against the reference with _raster_stochastic
patched to the interpret-mode Pallas tier (the patch changes nothing in
the reference package).

Tolerances, measured on these inputs:
  * tables, masks and draws: bit-exact;
  * K9's plain version against the interpreted kernel: XLA:CPU contracts
    the edge and depth planes' a*b+c into fused multiply-adds, PyTorch
    rounds each operation (tests/test_torch_raster.py), so a fragment on a
    pixel-centre edge or at the first-layer and interval limits can land on
    the other side: at most 1e-3 of the slots are filled on one side only
    (measured 3 of 36,864 at alpha 0.375, 0 at alpha 1.0); where both hold
    a depth it agrees to 2e-6 relative (measured 4.8e-7);
  * the pass (same inputs, linearized): at most 1% of the slots one-sided
    (measured 10 of 4,096 on CornellBox, 0 of 2,304 on Arcade), depths where
    both hold one to 1e-6 (measured 2.2e-7);
  * the graph: the golden runner's MSE bound 2e-4
    (rtsdm_tpu/testing/image_tests.py:96-100). Measured: 9.4e-6 against the
    committed golden test_SVAO_rasterSD.AmbientOcclusion.out.1.npy, which
    the reference made with its XLA-tier hash, and 9.4e-6 against the
    reference harness through the Pallas tier. The two reference runs agree
    to 1.5e-8: the hash barely moves the AO, and the port's difference comes
    from the G-buffer upstream (the reference's XLA:CPU raster fuses
    multiply-adds; the port's raster rounds as the Pallas kernel does),
    which moves the stencil on 30 of 16,384 pixels.
"""
import hashlib
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
from test_pallas_interpret import interpret_mode  # noqa: E402
from test_torch_cuda import (ADV_H, ADV_W, adversarial_floor,  # noqa: E402
                             adversarial_scene)
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.ops import raster_pallas as rpx  # noqa: E402
from rtsdm_tpu.passes import gbuffer as GJ  # noqa: E402
from rtsdm_tpu.passes import stochastic_depth as SDJ  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RCJ  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu.utils import sampling as UJ  # noqa: E402
from rtsdm_tpu_torch import _build  # noqa: E402
from rtsdm_tpu_torch.mogwai import Renderer, run_script  # noqa: E402
from rtsdm_tpu_torch.ops import raster as R  # noqa: E402
from rtsdm_tpu_torch.ops import raster_cuda as RC  # noqa: E402
from rtsdm_tpu_torch.ops import rt_cuda as RT  # noqa: E402
from rtsdm_tpu_torch.passes import stochastic_depth as SDT  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402
from rtsdm_tpu_torch.utils import sampling as U  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "SVAO_small.py"
REF = ROOT / "tests" / "image_refs" / \
    "test_SVAO_rasterSD.AmbientOcclusion.out.1.npy"
GOLDEN = ROOT / "tests" / "image_tests" / "renderpasses" / \
    "test_SVAO_rasterSD.py"
MSE_BOUND = 2e-4


def pallas_tier(scene, width, height, k, alpha, first_depth=None,
                ray_min=None, ray_max=None, cull="back", max_per_tile=256):
    """The reference's _raster_stochastic through raster_stochastic_pallas
    (its accelerator tier above 8,192 triangles)."""
    cam = scene.camera
    return rpx.raster_stochastic_pallas(
        cam.view_proj_no_jitter, scene.positions, cam.far_z, width=width,
        height=height, k=k, alpha=alpha, first_depth=first_depth,
        ray_min=ray_min, ray_max=ray_max, cull=cull)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_coverage_mask_matches_reference(k):
    idx, lut = U.stratified_coverage_tables(k)
    idx_j, lut_j = UJ.stratified_coverage_tables(k)
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(lut, lut_j)
    rng = np.random.default_rng(k)
    r1 = rng.random(4096, dtype=np.float32)
    r2 = rng.random(4096, dtype=np.float32)
    r1[:4] = [0.0, 0.625, 0.99999994, 0.5]
    for alpha in (0.1, 1.5 / k, 1.0):
        got = U.coverage_mask_select(alpha, torch.as_tensor(r1),
                                     torch.as_tensor(r2), k)
        ref = UJ.coverage_mask_select(alpha, jnp.asarray(r1), jnp.asarray(r2),
                                      k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fragment_draws_match_pallas_expression():
    """K9's two draws (raster_pallas.py:272-282, copied below in jnp):
    truncated pixel centres, original triangle ids, wrapping int32
    arithmetic, arithmetic shifts and the floor mod of |hb|."""
    rng = np.random.default_rng(13)
    n = 1 << 16
    px = (rng.integers(0, 4096, n) + 0.5).astype(np.float32)
    py = (rng.integers(0, 4096, n) + 0.5).astype(np.float32)
    oid = rng.integers(0, 1 << 22, n).astype(np.float32)
    golden = jnp.int32(0x9E3779B1 - (1 << 32))
    hb = (jnp.asarray(px).astype(jnp.int32) * 374761393
          ^ (jnp.asarray(py).astype(jnp.int32) * 668265263)
          ^ (jnp.asarray(oid).astype(jnp.int32) << 7))
    hb = (hb ^ (hb >> 13)) * golden
    hb = hb ^ (hb >> 16)
    rng_j = (jnp.abs(hb) % 32767).astype(jnp.float32) * (1.0 / 32767.0)
    h2 = (hb ^ (jnp.asarray(oid).astype(jnp.int32) * golden)) ^ (hb >> 5)
    rng2_j = (jnp.abs(h2) % 32767).astype(jnp.float32) * (1.0 / 32767.0)
    r1, r2 = RC.fragment_draws(torch.as_tensor(px), torch.as_tensor(py),
                               torch.as_tensor(oid))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(rng_j))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(rng2_j))
    # the wrapped |INT_MIN| keeps its sign: key 32765, as jnp.abs wraps
    assert int(RT.key15_of_hash(torch.tensor([-2**31]))[0]) == 32765


@pytest.fixture(scope="module")
def k9_case():
    """CornellBox 96x96 (k = 4): the first layer from the port's raster, a
    ray interval that drops some fragments (rayMin 0 on every third row,
    rayMax 0 on every seventh), and the interpreted Pallas kernel at alpha
    0.375 (config 2's 1.5 / k) and 1.0."""
    w = h = 96
    sj = PJ.cornell_box()
    st = carry(sj)
    cam = st.camera
    lin = cam.linearize_depth(R.rasterize(cam.view_proj_no_jitter,
                                          st.positions, width=w,
                                          height=h)["depth"]).numpy()
    rng = np.random.default_rng(5)
    rmin = (lin * rng.uniform(0.5, 1.0, (h, w))).astype(np.float32)
    rmin[::3] = 0.0
    rmax = (lin + rng.uniform(0.5, 20.0, (h, w))).astype(np.float32)
    rmax[::7] = 0.0
    ins = dict(first_depth=lin, ray_min=rmin, ray_max=rmax)
    ref = {}
    with interpret_mode(rpx):
        for alpha in (0.375, 1.0):
            ref[alpha] = np.asarray(rpx.raster_stochastic_pallas(
                sj.camera.view_proj_no_jitter, sj.positions, sj.camera.far_z,
                width=w, height=h, k=4, alpha=alpha,
                **{n: jnp.asarray(v) for n, v in ins.items()}))
    return dict(st=st, w=w, h=h, ins=ins, ref=ref, far=float(cam.far_z))


@pytest.mark.parametrize("alpha", [0.375, 1.0])
def test_raster_stochastic_matches_pallas_interpret(k9_case, alpha):
    c = k9_case
    cam = c["st"].camera
    got = R.raster_stochastic(
        cam.view_proj_no_jitter, c["st"].positions, cam.far_z, width=c["w"],
        height=c["h"], k=4, alpha=alpha,
        **{n: torch.as_tensor(v) for n, v in c["ins"].items()}).numpy()
    ref = c["ref"][alpha]
    assert got.shape == ref.shape == (c["h"], c["w"], 4)
    filled_r, filled_g = ref < c["far"], got < c["far"]
    assert 0.05 < filled_r.mean() < 0.95
    assert (filled_r != filled_g).mean() <= 1e-3
    both = filled_r & filled_g
    np.testing.assert_allclose(got[both], ref[both], rtol=2e-6, atol=0)
    np.testing.assert_array_equal(got[~filled_g], c["far"])
    if alpha == 1.0:   # floor(k + rng) = k: every fragment writes each slot
        assert (filled_r.all(-1) == filled_r.any(-1)).all()


# --- K9's per-triangle cull and split walk (csrc/raster_sd.cu) -------------

@pytest.fixture(scope="module", params=["CornellBox 128x128", "Arcade 64x48",
                                        "adversarial 70x45"])
def k9_cull_case(request):
    """K9's inputs on a scene of the package and on the adversarial scene
    of the K1 cull tests (near-degenerate triangles, which get the whole
    plane): (chunks, boxes, lists, counts, nby, nbx) and the per-pixel
    first layer (its view depth, no floor on about 30% of the pixels), ray
    minimum (0 on every third row) and maximum (0 on every seventh
    column), padded to the tiles."""
    from rtsdm_tpu_torch.scene.procedural import load_scene
    name = request.param.split()[0]
    if name == "adversarial":
        vp, pos = adversarial_scene()
        args = R._binned_chunks(torch.as_tensor(vp), torch.as_tensor(pos),
                                ADV_W, ADV_H, 0.0, 0.0, "none")[0]
        to_lin = adversarial_floor
    else:
        w, h = map(int, request.param.split()[1].split("x"))
        st = load_scene(name, aspect=w / h, device="cpu")
        args = R._binned_chunks(st.camera.view_proj_no_jitter, st.positions,
                                w, h, 0.0, 0.0, "back")[0]
        to_lin = st.camera.linearize_depth
    lin = to_lin(RC.raster_blocks_plain(args[0], None, *args[2:])[0])
    rng = np.random.default_rng(37)
    first = torch.where(torch.as_tensor(rng.random(lin.shape) < 0.3),
                        -3e38, lin)
    rmin = lin * torch.as_tensor(rng.uniform(0.5, 1.0, lin.shape)
                                 .astype(np.float32))
    rmin[::3] = 0.0
    rmax = lin + torch.as_tensor(rng.uniform(0.5, 20.0, lin.shape)
                                 .astype(np.float32))
    rmax[:, ::7] = 0.0
    return args, [a.contiguous() for a in (first, rmin, rmax)]


@pytest.mark.parametrize("alpha", [0.375, 1.0])
def test_k9_cull_equals_unrestricted(k9_cull_case, alpha):
    """The plain K9 restricted to each half tile's survivors of the cull
    boxes (lane_survivors) equals the unrestricted plain K9 bit for bit,
    padding pixels included, with complete lists and with lists of width 2
    that stream every chunk: the boxes bound K1's more tolerant fragment
    test, so they never cull a fragment K9 keeps."""
    (chunks, boxes, lists, counts, nby, nbx), planes = k9_cull_case
    for ls in (lists, lists[:, :2].contiguous()):
        want = RC.raster_stochastic_blocks_plain(chunks, None, ls, counts,
                                                 nby, nbx, *planes, 4, alpha)
        got = RC.raster_stochastic_blocks_plain(chunks, boxes, ls, counts,
                                                nby, nbx, *planes, 4, alpha)
        assert torch.equal(got, want)
    hit = want < RC.SD_EMPTY
    assert bool(hit.any()) and not bool(hit.all())


def test_k9_split_walk_merges_exactly(k9_cull_case):
    """K9's walk split into 3 parts (visits j = p, p + 3, ...), each part's
    slots merged by torch.minimum, equals the whole walk; so does the
    kernel's merge, atomicMin on the slots' bit patterns read as int32
    (replayed by view(torch.int32) and amin), since every stored value is
    a positive float. Complete lists and lists that stream every chunk."""
    (chunks, boxes, lists, counts, nby, nbx), planes = k9_cull_case
    for ls in (lists, lists[:, :2].contiguous()):
        args = (chunks, boxes, ls, counts, nby, nbx, *planes, 4, 0.375)
        whole = RC.raster_stochastic_blocks_plain(*args)
        parts = torch.stack([RC.raster_stochastic_blocks_plain(
            *args, part=(p, 3)) for p in range(3)])
        assert torch.equal(parts.amin(0), whole)
        assert bool((parts > 0).all())
        assert torch.equal(parts.view(torch.int32).amin(0)
                           .view(torch.float32), whole)


def test_raster_stochastic_blocks_checks_tri_boxes():
    """K9's wrapper refuses triangle boxes of another shape, type or device
    than the chunks' (ValueError, TypeError) and fewer than one part,
    before any dispatch."""
    chunks = torch.zeros((2, RC.COEF_ROWS, RC.TC))
    lists = torch.zeros((1, 1), dtype=torch.int32)
    counts = torch.ones((1,), dtype=torch.int32)
    planes = (torch.zeros((8, 32)), torch.zeros((8, 32)),
              torch.ones((8, 32)))
    good = torch.zeros((2, 4, RC.TC))
    out = RC.raster_stochastic_blocks(chunks, good, lists, counts, 1, 1,
                                      *planes, 4, 0.375)
    assert out.shape == (4, 8, 32) and bool((out == RC.SD_EMPTY).all())
    for bad in (torch.zeros((1, 4, RC.TC)), torch.zeros((2, 5, RC.TC)),
                good.to("meta")):
        with pytest.raises(ValueError, match="tri_boxes|inconsistent"):
            RC.raster_stochastic_blocks(chunks, bad, lists, counts, 1, 1,
                                        *planes, 4, 0.375)
    with pytest.raises(TypeError, match="tri_boxes"):
        RC.raster_stochastic_blocks(chunks, good.double(), lists, counts, 1,
                                    1, *planes, 4, 0.375)
    with pytest.raises(ValueError, match="parts"):
        RC.raster_stochastic_blocks(chunks, good, lists, counts, 1, 1,
                                    *planes, 4, 0.375, parts=0)


@pytest.mark.parametrize("name,w,h", [("CornellBox", 128, 128),
                                      ("Arcade", 128, 72)])
def test_stochastic_depth_pass_matches_reference(name, w, h):
    """StochasticDepthMap (divisor 4, linearized, the nested pass of
    config 2) on the same G-buffer depth and ray interval as the reference
    pass through the Pallas tier."""
    sj = PJ.load_scene(name, aspect=w / h)
    st = carry(sj)
    g = GJ.raster_gbuffer(sj, w, h)
    sw, sh = w // 4, h // 4
    lin = np.asarray(sj.camera.linearize_depth(g["depth"]))
    lo = lin.reshape(sh, 4, sw, 4).min((1, 3))
    rng = np.random.default_rng(3)
    rmin = (lo * rng.uniform(0.9, 1.0, lo.shape)).astype(np.float32)
    rmin[::5] = 0.0
    rmax = (lo + rng.uniform(0.3, 8.0, lo.shape)).astype(np.float32)
    rmax[:, ::6] = 0.0
    props = dict(SampleCount=4, Alpha=0.375, linearize=True, divisor=4)
    pj = SDJ.StochasticDepthMap(props)
    pj.set_scene(sj)
    ins = {"depthMap": np.asarray(g["depth"]), "rayMin": rmin, "rayMax": rmax}
    with interpret_mode(rpx), mock.patch.object(SDJ, "_raster_stochastic",
                                                pallas_tier):
        ref = np.asarray(pj.execute(
            RCJ(width=w, height=h, scene=sj),
            {n: jnp.asarray(v) for n, v in ins.items()})[0]["stochasticDepth"])
    pt = SDT.StochasticDepthMap(props)
    pt.set_scene(st)
    got = pt.execute(RenderContext(width=w, height=h, scene=st),
                     {n: torch.as_tensor(v) for n, v in ins.items()})[0]
    got = got["stochasticDepth"].numpy()
    assert got.shape == ref.shape == (sh, sw, 4)
    assert got.min() >= 0.0 and got.max() <= 1.0
    hit_r, hit_g = ref < 1.0, got < 1.0
    assert hit_r.any()
    assert (hit_r != hit_g).mean() <= 1e-2
    both = hit_r & hit_g
    np.testing.assert_allclose(got[both], ref[both], atol=1e-6, rtol=0)


def test_uv_grid_matches_reference():
    np.testing.assert_array_equal(SDT._uv_grid(7, 12, device="cpu").numpy(),
                                  np.asarray(SDJ._uv_grid(7, 12)))


def _golden_settings():
    ns = {}
    exec(GOLDEN.read_text(), ns)
    return ns["IMAGE_TEST"]


def _setup(m, run, cfg):
    run(str(SCRIPT), m)
    for p in m.active_graph.passes.values():
        if p.pass_type == "GuardBand":
            p.cfg["guardBand"] = cfg["guard_band"]
    for name, props in cfg["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    m.loadScene(cfg["scene"])
    m.clock.pause()


@pytest.fixture(scope="module")
def raster_sd_frame():
    """SVAO_small.py with Raster SD through the port's harness at the
    settings of tests/image_tests/renderpasses/test_SVAO_rasterSD.py
    (CornellBox 128x128, guard band 8, set after the graph was built),
    counting which SD raster each frame runs."""
    cfg = _golden_settings()
    m = Renderer(cfg["width"], cfg["height"], device="cpu")
    _setup(m, run_script, cfg)
    ran = []
    real = SDT.raster_stochastic

    def rec(*a, **kw):
        ran.append("raster")
        return real(*a, **kw)

    def no_trace(*a, **kw):
        raise AssertionError("the ray-traced SD ran")

    _build.LAUNCHES.clear()
    with mock.patch.object(SDT, "raster_stochastic", rec), \
            mock.patch.object(RT, "sd_trace_blocks", no_trace), \
            mock.patch.object(RT, "sd_trace_resident_blocks", no_trace):
        for f in range(2):
            m.clock.frame = f
            out = m.renderFrame()
    assert sum(_build.LAUNCHES.values()) == 0   # CPU tensors: plain versions
    return cfg, m, out, ran


def test_svao_raster_sd_graph_matches_golden(raster_sd_frame):
    cfg, m, out, ran = raster_sd_frame
    assert ran == ["raster", "raster"]
    sd_graph = m.active_graph.get_pass("SVAO")._sd_graph
    assert sd_graph.passes["StochasticDepthMap"].pass_type == \
        "StochasticDepthMap"
    before = hashlib.sha256(REF.read_bytes()).hexdigest()
    ref = np.load(REF).astype(np.float32)
    img = out["AmbientOcclusion.out"].numpy().astype(np.float32)
    assert img.shape == ref.shape == (cfg["height"], cfg["width"], 4)
    assert np.isfinite(img).all()
    mse = float(((img - ref) ** 2).mean())
    assert mse <= MSE_BOUND, mse
    assert hashlib.sha256(REF.read_bytes()).hexdigest() == before


@pytest.mark.slow
def test_svao_raster_sd_graph_matches_reference_harness(raster_sd_frame):
    """The same frames from the reference harness with the SD raster on
    its Pallas tier (about a minute, op by op)."""
    import rtsdm_tpu.mogwai as JM
    cfg, _, out, _ = raster_sd_frame
    with interpret_mode(rpx), mock.patch.object(SDJ, "_raster_stochastic",
                                                pallas_tier):
        mj = JM.Renderer(cfg["width"], cfg["height"], use_jit=False)
        _setup(mj, JM.run_script, cfg)
        for f in range(2):
            mj.clock.frame = f
            ref = mj.renderFrame()
    ref = np.asarray(ref["AmbientOcclusion.out"], np.float32)
    img = out["AmbientOcclusion.out"].numpy()
    assert float(((img - ref) ** 2).mean()) <= MSE_BOUND
    golden = np.load(REF).astype(np.float32)
    assert float(((ref - golden) ** 2).mean()) <= 1e-6
