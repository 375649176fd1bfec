"""BASELINE config 1 (scripts/HBAO.py) in rtsdm_tpu_torch against rtsdm_tpu
on the CPU: the HBAO ring's same-class fetch (K6's plain version), the
interleave passes, MaterialDoubleSided, the camera's radius projection, the
HBAO pass in both sampling modes and both depth modes, and the whole graph
through the port's harness against the committed goldens.

References: fetch_taps_same_class in interpret mode (the TPU tier of the
ring fetch); the reference passes run eagerly on the same inputs; the
goldens tests/image_refs/test_HBAO.*.npy (the JAX package's output at the
settings of tests/image_tests/renderpasses/test_HBAO.py), only read.

Tolerances: the fetch, the interleaves and the flag are bit-exact; the
HBAO pass agrees to 1e-6 (measured max 1.2e-7 over Gather and Shift, single
and dual depth: the same float32 operations, a few of which XLA:CPU fuses
into multiply-adds);
the graph meets the golden runner's MSE bound 2e-4
(rtsdm_tpu/testing/image_tests.py:96-100; measured 9.0e-7 on Ambient.out
and 7.9e-5 on Diffuse.out, where the lit colour of the G-buffer and
ForwardLighting tiers adds its own differences).
"""
import hashlib
import sys
from pathlib import Path

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
from rtsdm_tpu.ops import ao_shift as SJ  # noqa: E402
from rtsdm_tpu.ops import fetch_pallas as FP  # noqa: E402
from rtsdm_tpu.passes import depth_chain as DJ  # noqa: E402
from rtsdm_tpu.passes import gbuffer as GJ  # noqa: E402
from rtsdm_tpu.passes import hbao as HJ  # noqa: E402
from rtsdm_tpu.passes import interleave as IJ  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RCJ  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu_torch import _build  # noqa: E402
from rtsdm_tpu_torch.mogwai import Renderer, run_script  # noqa: E402
from rtsdm_tpu_torch.ops import ao_shift as S  # noqa: E402
from rtsdm_tpu_torch.ops import fetch_cuda as F  # noqa: E402
from rtsdm_tpu_torch.passes import depth_chain as DT  # noqa: E402
from rtsdm_tpu_torch.passes import hbao as HT  # noqa: E402
from rtsdm_tpu_torch.passes import interleave as IT  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "HBAO.py"
REFS = ROOT / "tests" / "image_refs"
GOLDEN = ROOT / "tests" / "image_tests" / "renderpasses" / "test_HBAO.py"
MSE_BOUND = 2e-4


def test_static_tables_match_reference():
    """HBAO_NOISE, generated by the same numpy calls, is the reference's
    table; the Shift path's levels and offsets are the expressions of
    rtsdm_tpu/passes/hbao.py:215-241 evaluated in numpy."""
    np.testing.assert_array_equal(HT.HBAO_NOISE, HJ.HBAO_NOISE)
    levels, pad, offs = HT.shift_tables()
    np.testing.assert_array_equal(levels, AJ.shift_radius_levels(48.0))
    assert pad == int(np.ceil(levels[-1]))
    for i, d_np in enumerate(HT.direction_tables()):
        theta = 2.0 * 3.141 / 8 * float(i)
        ref = np.stack([HJ.HBAO_NOISE[:, 0] * np.cos(theta)
                        - HJ.HBAO_NOISE[:, 1] * np.sin(theta),
                        HJ.HBAO_NOISE[:, 0] * np.sin(theta)
                        + HJ.HBAO_NOISE[:, 1] * np.cos(theta)],
                       axis=-1).astype(np.float32)
        np.testing.assert_array_equal(d_np, ref)
        assert offs[i] == tuple(
            tuple((int(round(float(r) * ref[s, 1])),
                   int(round(float(r) * ref[s, 0]))) for r in levels)
            for s in range(16))


@pytest.fixture(scope="module")
def taps_case():
    """Two padded plane sets, per-step level planes, and
    fetch_taps_same_class on both sets in interpret mode: two of the ring's
    directions (1 and 6, in opposite half-planes) x 2 steps; interpret mode
    costs ~5 s per direction (all 8 x 4 run in the Shift cases of
    test_hbao_pass_matches_reference). Each set's taps depend on that set
    alone, so the first set's are the reference of a one-set call."""
    rng = np.random.default_rng(23)
    qh, qw = 24, 40
    levels, pad, offs = HT.shift_tables()
    offs = (offs[1], offs[6])
    ray0 = rng.uniform(0.5, 40.0, (16, qh, qw)).astype(np.float32)
    lvl = np.stack([np.asarray(AJ.shift_level_index(
        levels, jnp.clip(jnp.asarray(ray0) * (1.0 + 0.7 * k), 1.0, 48.0)))
        for k in range(2)])
    sets = [SJ.pad_planes(jnp.asarray(rng.uniform(1.0, 30.0, (16, qh, qw))
                                      .astype(np.float32)), pad)
            for _ in range(2)]
    with interpret_mode(FP):
        ref = np.asarray(FP.fetch_taps_same_class(
            sets, jnp.asarray(lvl), pad=pad, offs_key=offs, taps_per_dir=2))
    return dict(planes=torch.stack([torch.as_tensor(np.array(p))
                                    for p in sets]),
                lvl=torch.as_tensor(lvl), pad=pad, offs=offs, ref=ref)


@pytest.mark.parametrize("n_src", [1, 2])
def test_fetch_taps_same_class_matches_pallas_interpret(taps_case, n_src):
    """K6's plain version against fetch_taps_same_class in interpret mode,
    bit for bit (the pattern of tests/test_pallas_interpret.py:648-693)."""
    c = taps_case
    got = F.fetch_taps_same_class(c["planes"][:n_src], c["lvl"], c["pad"],
                                  c["offs"])
    assert got.shape == (n_src, 4, 16, 24, 40)
    np.testing.assert_array_equal(got.numpy(), c["ref"][:n_src])


@pytest.mark.parametrize("shape", [(64, 96), (30, 45), (30, 45, 3)])
def test_interleave_matches_reference(shape):
    """De- and interleave, bit-exact, with the edge-clamp pad where H or W
    is not a multiple of 4; interleave(deinterleave(x)) == x."""
    x = np.random.default_rng(7).uniform(0, 1, shape).astype(np.float32)
    dq = IT.deinterleave_4x4(torch.as_tensor(x))
    np.testing.assert_array_equal(dq.numpy(),
                                  np.asarray(IJ.deinterleave_4x4(x)))
    back = IT.interleave_4x4(dq, *shape[:2])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(IJ.interleave_4x4(jnp.asarray(dq.numpy()),
                                                   *shape[:2])))
    np.testing.assert_array_equal(back.numpy(), x)
    ctx = RenderContext(width=shape[1], height=shape[0])
    dq_pass = IT.DeinterleaveTexture().execute(
        ctx, {"texIn": torch.as_tensor(x)})[0]["texOut"]
    assert torch.equal(dq_pass, dq)
    np.testing.assert_array_equal(
        IT.InterleaveTexture().execute(ctx, {"texIn": dq_pass})[0]["texOut"]
        .numpy(), x)


def test_material_double_sided_and_radius_match_reference():
    """MaterialDoubleSided on an Arcade G-buffer (which holds double-sided
    foliage and background pixels), and the camera's view-space radius
    projection, bit-exact. The material ids come from the port's G-buffer
    (held against the reference's in test_torch_raster.py): the reference
    raster of Arcade's 38,610 triangles would take ~9 s here."""
    from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer
    sj = PJ.arcade(aspect=1.5)
    st = carry(sj)
    mid = raster_gbuffer(st, 48, 32)["mtlData"].numpy()
    ref = DJ.MaterialDoubleSided().execute(
        RCJ(width=48, height=32, scene=sj), {"mtlData": jnp.asarray(mid)})[0]
    got = DT.MaterialDoubleSided().execute(
        RenderContext(width=48, height=32, scene=st),
        {"mtlData": torch.as_tensor(mid)})[0]
    np.testing.assert_array_equal(got["doubleSided"].numpy(),
                                  np.asarray(ref["doubleSided"]))
    z = np.random.default_rng(2).uniform(0.1, 40.0, (5, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(
        st.camera.view_space_radius_to_uv_radius(torch.as_tensor(z), 0.7)
        .numpy(),
        np.asarray(sj.camera.view_space_radius_to_uv_radius(
            jnp.asarray(z), jnp.float32(0.7))))


@pytest.fixture(scope="module")
def hbao_inputs():
    """Deinterleaved first-layer linear depth of CornellBox 64x64, a second
    layer behind it, and the G-buffer's face normals."""
    w = h = 64
    sj = PJ.cornell_box()
    g = GJ.raster_gbuffer(sj, w, h)
    dq = IJ.deinterleave_4x4(sj.camera.linearize_depth(g["depth"]))
    rng = np.random.default_rng(1)
    dq2 = dq + jnp.asarray(rng.uniform(0.0, 2.0, dq.shape).astype(np.float32))
    return dict(sj=sj, st=carry(sj), w=w, h=h,
                ins={"depth": np.asarray(dq), "depth2": np.asarray(dq2),
                     "normals": np.asarray(g["faceNormalW"])})


def _port_hbao(hbao_inputs, props):
    d = hbao_inputs
    return HT.HBAO(props).execute(
        RenderContext(width=d["w"], height=d["h"], scene=d["st"]),
        {k: torch.as_tensor(v) for k, v in d["ins"].items()})[0]["ambientMap"]


@pytest.mark.parametrize("depth_mode", ["SingleDepth", "DualDepth"])
@pytest.mark.parametrize("sampling", ["Gather", "Shift"])
def test_hbao_pass_matches_reference(hbao_inputs, sampling, depth_mode):
    d = hbao_inputs
    props = dict(samplingMode=sampling, depthMode=depth_mode, radius=1.0)
    pass_j = HJ.HBAO(props)

    # compiled once: the reference's Shift path dispatches a scan per tap
    @jax.jit
    def ref_fn(ins):
        return pass_j.execute(RCJ(width=d["w"], height=d["h"],
                                  scene=d["sj"]), ins)[0]["ambientMap"]
    ref = ref_fn({k: jnp.asarray(v) for k, v in d["ins"].items()})
    got = _port_hbao(hbao_inputs, props)
    assert got.shape == (16, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    assert float(got.min()) < 0.9      # the ring found occluders


def test_hbao_auto_takes_gather_on_cpu(hbao_inputs):
    """samplingMode 'Auto' follows the reference's rule: Shift on the
    accelerator, Gather on the CPU."""
    auto = _port_hbao(hbao_inputs, dict(samplingMode="Auto"))
    gather = _port_hbao(hbao_inputs, dict(samplingMode="Gather"))
    shift = _port_hbao(hbao_inputs, dict(samplingMode="Shift"))
    assert torch.equal(auto, gather)
    assert not torch.equal(auto, shift)
    with pytest.raises(ValueError):
        _port_hbao(hbao_inputs, dict(samplingMode="Ring"))


def test_depth_peeling_is_the_floored_raster():
    """DepthPeeling renders the scene again with the first layer's linear
    depth + minSeparationDistance as K1's floor: NDC depth of a layer
    behind the first one, 1.0 where nothing lies behind."""
    from rtsdm_tpu_torch.ops.raster import rasterize
    from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer
    st = carry(PJ.arcade(aspect=1.5))
    g = raster_gbuffer(st, 48, 32)
    lin = st.camera.linearize_depth(g["depth"])
    out, _ = DT.DepthPeeling({"minSeparationDistance": 0.5,
                              "maxPerTile": 64}).execute(
        RenderContext(width=48, height=32, scene=st), {"linearZ": lin})
    want = rasterize(st.camera.view_proj_no_jitter, st.positions, width=48,
                     height=32, depth_floor=lin, min_separation=0.5)
    assert torch.equal(out["depth2"], want["depth"])
    lin2 = st.camera.linearize_depth(out["depth2"])
    behind = out["depth2"] < 1.0
    assert bool(behind.any())
    assert bool((lin2[behind] > lin[behind] + 0.5).all())


def _golden_settings():
    ns = {}
    exec(GOLDEN.read_text(), ns)
    return ns["IMAGE_TEST"], ns["OUTPUTS"]


@pytest.fixture(scope="module")
def hbao_frames():
    """scripts/HBAO.py through the port's harness at the golden settings
    (CornellBox 96x96, guard band 8, maxPerTile overrides, paused clock)."""
    cfg, outputs = _golden_settings()
    m = Renderer(cfg["width"], cfg["height"], device="cpu")
    run_script(str(SCRIPT), m)
    m.active_graph.get_pass("GuardBand").cfg["guardBand"] = cfg["guard_band"]
    for name, props in cfg["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    m.loadScene(cfg["scene"])
    m.clock.pause()
    _build.LAUNCHES.clear()
    frames = {}
    for f in range(max(cfg["frames"]) + 1):
        m.clock.frame = f
        frames[f] = m.renderFrame()
    assert sum(_build.LAUNCHES.values()) == 0   # CPU tensors: plain versions
    return cfg, outputs, frames


@pytest.mark.parametrize("output", ["Ambient.out", "Diffuse.out"])
def test_hbao_script_matches_goldens(hbao_frames, output):
    cfg, outputs, frames = hbao_frames
    assert output in outputs
    for f in cfg["frames"]:
        out = frames[f]
        assert set(out) == set(outputs)
        path = REFS / f"test_HBAO.{output}.{f}.npy"
        before = hashlib.sha256(path.read_bytes()).hexdigest()
        ref = np.load(path).astype(np.float32)
        img = out[output].numpy().astype(np.float32)
        assert img.shape == ref.shape == (cfg["height"], cfg["width"], 4)
        assert np.isfinite(img).all()
        mse = float(((img - ref) ** 2).mean())
        assert mse <= MSE_BOUND, (output, f, mse)
        assert hashlib.sha256(path.read_bytes()).hexdigest() == before


def test_shift_taps_are_the_table_entries():
    """On the Shift path the tap a texel reads is the same-class table entry
    of its level: the plain fetch equals an explicit per-texel read."""
    levels, pad, offs = HT.shift_tables()
    rng = np.random.default_rng(3)
    qh, qw = 6, 9
    planes = S.pad_planes(torch.as_tensor(
        rng.uniform(0, 1, (16, qh, qw)).astype(np.float32)), pad)
    lvl = torch.as_tensor(rng.integers(-1, len(levels) + 1, (4, 16, qh, qw))
                          .astype(np.int32))
    got = F.fetch_taps_same_class(planes[None], lvl, pad, offs)[0]
    for t, c, y, x in rng.integers(0, [32, 16, qh, qw], (200, 4)):
        d, k = divmod(int(t), 4)
        lv = int(lvl[k, c, y, x])
        if not 0 <= lv < len(levels):
            assert float(got[t, c, y, x]) == 0.0
            continue
        dy, dx = (max(-pad, min(pad, v)) for v in offs[d][c][lv])
        assert float(got[t, c, y, x]) == float(planes[c, pad + dy + y,
                                                      pad + dx + x])
