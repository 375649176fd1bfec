"""Parity of rtsdm_tpu_torch's scene animation, curve caches, sample
patterns and animated G-buffer with the rtsdm_tpu reference on the CPU,
and the harness's animation (BASELINE config 5's camera path, node track
and node selection).

Tolerances: keyframe sampling, node matrices and sample patterns are the
reference's numpy code and are bit-exact. The animated soup is held to
atol 1e-6 at CornellBox's magnitudes (|p| < 3; measured 2.4e-7) and the
rotated normals to 1e-6 (measured 1.2e-7): XLA:CPU evaluates its einsums
with fused multiply-adds where PyTorch rounds every product (ROADMAP
hazards j, n). Tubes take a cosine and sine of their ring angles, which
the two libraries may round differently: 1e-6 (measured 7.5e-9). Camera
matrices 1e-6, as tests/test_torch_scene.py holds them. Motion vectors as the G-buffer's
other channels in tests/test_torch_raster.py: 2e-4 where the two rasters
pick the same triangle (the XLA raster contracts its edge functions).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.passes import gbuffer as GJ  # noqa: E402
from rtsdm_tpu.scene import animation as AJ  # noqa: E402
from rtsdm_tpu.scene import curves as CJ  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu.scene.scene import make_scene as make_scene_j  # noqa: E402
from rtsdm_tpu.utils import sampling as SJ  # noqa: E402
from rtsdm_tpu.utils.structs import replace  # noqa: E402
from rtsdm_tpu_torch.passes import gbuffer as GT  # noqa: E402
from rtsdm_tpu_torch.scene import animation as AT  # noqa: E402
from rtsdm_tpu_torch.scene import curves as CT  # noqa: E402
from rtsdm_tpu_torch.scene.camera import CAMERA_FIELDS, Camera  # noqa: E402
from rtsdm_tpu_torch.scene.scene import SCENE_FIELDS, make_scene  # noqa: E402
from rtsdm_tpu_torch.utils import sampling as ST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POS_ATOL = 1e-6
NORMAL_ATOL = 1e-6
TUBE_ATOL = 1e-6
CAMERA_ATOL = 1e-6
MVEC_ATOL = 2e-4
MAX_ID_MISMATCH = 1e-3
ORBIT = dict(center=(0.0, 2.0, 0.0), radius=45.0, height=14.0, duration=8.0)
# keyframes across which NodeTrack interpolates T, S and slerps R
KEYS = [dict(time=0.0, translation=(0, 0, 0)),
        dict(time=0.5, translation=(0.3, -0.2, 0.1),
             rotation=(0.0, np.sin(0.4), 0.0, np.cos(0.4)),
             scaling=(1.2, 1.0, 0.8)),
        dict(time=1.25, translation=(-0.4, 0.5, 0.2),
             rotation=(np.sin(0.3), 0.0, 0.0, np.cos(0.3)))]
TIMES = (0.0, 0.2, 0.5, 0.9, 1.25, 1.6, 3.7)    # across keys and the loop


def t(a):
    return torch.as_tensor(np.array(a))


def cameras_close(ct, cj, atol=CAMERA_ATOL):
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), atol=atol,
                                   rtol=0, err_msg=f)


def tracks(mod):
    return {1: mod.NodeTrack.spin_y((0.3, 0.0, -0.2), period=2.0),
            2: mod.NodeTrack.oscillate((0.0, 1.0, 0.0), 0.5, 4.0),
            3: mod.NodeTrack(KEYS)}


@pytest.fixture(scope="module")
def cornell_nodes():
    """CornellBox with its triangles on nodes 0-3, in both packages."""
    sj = PJ.cornell_box()
    node = (np.arange(int(sj.num_triangles)) % 4).astype(np.int32)
    sj = replace(sj, node_id=jnp.asarray(node))
    return sj, carry(sj)


@pytest.mark.parametrize("pattern,count", [("Center", 8), ("DirectX", 8),
                                           ("Halton", 8), ("Halton", 5),
                                           ("Stratified", 8),
                                           ("Stratified", 6)])
def test_sample_pattern_offsets_match_reference(pattern, count):
    got = ST.sample_pattern_offsets(pattern, count)
    want = SJ.sample_pattern_offsets(pattern, count)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.all(got >= -0.5) and np.all(got < 0.5)


def test_pattern_jitter_matches_reference():
    """GBufferRaster's per-frame camera jitter: offset frame % N of the
    pattern over the render size, divided on the host in float32."""
    sj = PJ.cornell_box()
    st = carry(sj)
    for pattern in ("Center", "DirectX", "Halton", "Stratified"):
        for frame in (0, 3, 11):
            cj = GJ.pattern_jittered_scene(sj, pattern, 8, frame, 96,
                                           72).camera
            ct = GT.pattern_jittered_scene(st, pattern, 8, frame, 96,
                                           72).camera
            for f in ("jitter_x", "jitter_y"):
                np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                              np.asarray(getattr(cj, f)))


def test_camera_path_matches_reference():
    """CameraPath.eval (Catmull-Rom through the orbit's keys, looping) is
    the reference's numpy code; camera_at builds the reference's camera and
    its prev matrices (the path at time - dt, clamped at 0)."""
    pj, pt = AJ.CameraPath.orbit(**ORBIT), AT.CameraPath.orbit(**ORBIT)
    sj = PJ.cornell_box()
    base_j, base_t = sj.camera, carry(sj).camera
    for time_s in (0.0, 1 / 60, 2.9, 7.99, 9.5):
        for a, b in zip(pt.eval(time_s), pj.eval(time_s)):
            np.testing.assert_array_equal(a, b)
        ct = pt.camera_at(time_s, base_t, aspect=16 / 9, focal=18.0)
        cj = pj.camera_at(time_s, base_j, aspect=16 / 9, focal=18.0)
        cameras_close(ct, cj)
        prev = pt.camera_at(max(time_s - 1 / 60, 0.0), base_t,
                            aspect=16 / 9, focal=18.0)
        assert torch.equal(ct.prev_view_mat, prev.view_mat)
        assert torch.equal(ct.prev_view_proj_no_jitter,
                           prev.view_proj_no_jitter)
        assert torch.equal(ct.prev_pos_w, prev.pos_w)
    assert not torch.equal(ct.view_mat, ct.prev_view_mat)


def test_camera_create_prev_matches_reference():
    kw = dict(target=(0.0, 1.0, 0.0), focal_length=24.0, aspect=1.5)
    prev_j = AJ.Camera.create(position=(2.0, 1.0, 5.0), **kw)
    cj = AJ.Camera.create(position=(2.5, 1.2, 4.0), prev=prev_j, **kw)
    prev_t = Camera.create(position=(2.0, 1.0, 5.0), device="cpu", **kw)
    ct = Camera.create(position=(2.5, 1.2, 4.0), prev=prev_t, device="cpu",
                       **kw)
    cameras_close(ct, cj)
    assert ct.prev_view_mat is prev_t.view_mat
    assert ct.prev_pos_w is prev_t.pos_w


@pytest.mark.parametrize("track", ["spin_y", "oscillate", "keys"])
def test_node_track_sample_matches_reference(track):
    tj, tt = {"spin_y": (AJ.NodeTrack.spin_y((1.0, 0.0, 2.0), 3.0),
                         AT.NodeTrack.spin_y((1.0, 0.0, 2.0), 3.0)),
              "oscillate": (AJ.NodeTrack.oscillate((0.0, 1.0, 0.0), 0.5, 4.0),
                            AT.NodeTrack.oscillate((0.0, 1.0, 0.0), 0.5,
                                                   4.0)),
              "keys": (AJ.NodeTrack(KEYS), AT.NodeTrack(KEYS))}[track]
    for time_s in TIMES:
        got = tt.sample(time_s)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, tj.sample(time_s))


def test_animation_controller_matches_reference(cornell_nodes):
    """AnimationController.animate: the animated soup, its rotated
    normals and last frame's soup (prev_positions) of every node."""
    sj, st = cornell_nodes
    cj = AJ.AnimationController(tracks(AJ), dt=0.05)
    ct = AT.AnimationController(tracks(AT), dt=0.05)
    for time_s in (0.0, 0.37, 2.6):
        np.testing.assert_array_equal(ct.node_matrices(time_s),
                                      cj.node_matrices(time_s))
        aj, at = cj.animate(sj, time_s), ct.animate(st, time_s)
        for f, atol in (("positions", POS_ATOL),
                        ("prev_positions", POS_ATOL),
                        ("normals", NORMAL_ATOL)):
            np.testing.assert_allclose(getattr(at, f).numpy(),
                                       np.asarray(getattr(aj, f)),
                                       atol=atol, rtol=0, err_msg=f)
        # node 0 stays where it was; the scene given is not written
        still = st.node_id == 0
        assert torch.equal(at.positions[still], st.positions[still])
    assert torch.equal(st.positions, t(sj.positions))


@pytest.fixture(scope="module")
def skinned():
    """Random skinned soup (two joints, up to four influences a vertex,
    one triangle rigid) in both packages."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(-1, 1, (6, 3, 3)).astype(np.float32)
    joints = rng.integers(0, 2, (6, 3, 4)).astype(np.int32)
    weights = rng.uniform(0, 1, (6, 3, 4)).astype(np.float32)
    weights[0] = 0.0
    node = np.zeros(6, np.int32)
    sj = make_scene_j("skin", pos, skin_joints=joints, skin_weights=weights,
                      node_id=node, morton_sort=True)
    st = make_scene("skin", pos, skin_joints=joints, skin_weights=weights,
                    node_id=node, morton_sort=True, device="cpu")
    return sj, st


def test_make_scene_orders_animation_fields_as_reference(skinned):
    sj, st = skinned
    for f in ("positions", "node_id", "skin_joints", "skin_weights"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert st.prev_positions is None and sj.prev_positions is None
    plain = make_scene("tri", np.zeros((2, 3, 3), np.float32), device="cpu")
    assert plain.node_id.tolist() == [0, 0] and plain.skin_joints is None
    assert set(SCENE_FIELDS) >= {"node_id", "prev_positions", "skin_joints",
                                 "skin_weights"}


def test_skinned_controller_matches_reference(skinned):
    sj, st = skinned
    bind_inv = np.stack([np.eye(4), np.linalg.inv(
        AJ.NodeTrack.spin_y((0.2, 0.0, 0.0), 2.0).sample(0.3))])
    trk = {0: (AJ.NodeTrack(KEYS), AT.NodeTrack(KEYS)),
           1: (AJ.NodeTrack.spin_y((0.0, 0.0, 0.5), 2.0),
               AT.NodeTrack.spin_y((0.0, 0.0, 0.5), 2.0))}
    cj = AJ.SkinnedController({k: v[0] for k, v in trk.items()}, bind_inv)
    ct = AT.SkinnedController({k: v[1] for k, v in trk.items()}, bind_inv)
    for time_s in (0.1, 0.9):
        aj, at = cj.animate(sj, time_s), ct.animate(st, time_s)
        for f in ("positions", "prev_positions"):
            np.testing.assert_allclose(getattr(at, f).numpy(),
                                       np.asarray(getattr(aj, f)),
                                       atol=POS_ATOL, rtol=0, err_msg=f)
        # the reference scales every face normal by one matrix norm
        # (jnp.linalg.norm(fn, -1, keepdims=True) reads -1 as its order):
        # the port makes each a unit vector, in the reference's direction
        nj = np.asarray(aj.normals)
        nj = nj / np.linalg.norm(nj, axis=-1, keepdims=True)
        np.testing.assert_allclose(at.normals.numpy(), nj, atol=NORMAL_ATOL,
                                   rtol=0)
        rigid = (st.skin_weights.sum(-1) == 0)
        assert rigid.any()
        assert torch.equal(at.positions[rigid], st.positions[rigid])


@pytest.fixture(scope="module")
def strands():
    rng = np.random.default_rng(3)
    base = np.cumsum(rng.normal(0, 0.2, (2, 5, 3)), 1).astype(np.float32)
    base[1, :, 1] = np.linspace(0.0, 2.0, 5)     # a vertical strand
    base[1, :, (0, 2)] = 0.0
    keys = np.stack([base, base + 0.1, base - 0.2]).astype(np.float32)
    radii = np.linspace(0.05, 0.01, 5).astype(np.float32)
    return keys, radii


def test_curve_tubes_match_reference(strands):
    keys, radii = strands
    for a, b in zip(CT.curve_frames(t(keys[0])),
                    CJ.curve_frames(jnp.asarray(keys[0]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TUBE_ATOL,
                                   rtol=0)
    for sides in (3, 4, 6):
        got = CT.poly_tube_mesh(t(keys[0]), radii, sides).numpy()
        want = np.asarray(CJ.poly_tube_mesh(keys[0], radii, sides))
        assert got.shape == want.shape == (
            CT.poly_tube_tri_count(2, 5, sides), 3, 3)
        np.testing.assert_allclose(got, want, atol=TUBE_ATOL, rtol=0)


def test_vertex_caches_match_reference(strands):
    """CachedMeshTrack and CachedCurveTrack keyframe brackets and
    positions, and VertexCacheController composing them with a node track
    over a scene's triangle ranges (positions, prev_positions, normals)."""
    keys, radii = strands
    times = [0.0, 0.4, 1.0]
    n_tube = CT.poly_tube_tri_count(2, 5, 4)
    rng = np.random.default_rng(5)
    mesh = rng.uniform(-1, 1, (3, 4, 3, 3)).astype(np.float32)
    soup = rng.uniform(-1, 1, (4 + n_tube + 3, 3, 3)).astype(np.float32)
    node = np.zeros(len(soup), np.int32)
    node[-3:] = 1
    sj = make_scene_j("caches", soup, node_id=node, morton_sort=False)
    st = make_scene("caches", soup, node_id=node, morton_sort=False,
                    device="cpu")

    def controller(A, C):
        return C.VertexCacheController(
            [C.CachedMeshTrack(times, 0, mesh),
             C.CachedCurveTrack(times, 4, keys, radii)],
            tracks={1: A.NodeTrack.oscillate((1.0, 0.0, 0.0), 0.3, 2.0)},
            dt=0.1)

    cj, ct = controller(AJ, CJ), controller(AT, CT)
    for time_s in (0.05, 0.4, 0.73, 1.3):
        for a, b in zip(ct.caches, cj.caches):
            assert a.bracket(time_s) == b.bracket(time_s)
            np.testing.assert_allclose(a.positions(time_s, "cpu").numpy(),
                                       np.asarray(b.positions(time_s)),
                                       atol=TUBE_ATOL, rtol=0)
        aj, at = cj.animate(sj, time_s), ct.animate(st, time_s)
        for f in ("positions", "prev_positions", "normals"):
            np.testing.assert_allclose(getattr(at, f).numpy(),
                                       np.asarray(getattr(aj, f)),
                                       atol=TUBE_ATOL, rtol=0, err_msg=f)
    assert torch.equal(st.positions, t(soup))


def test_gbuffer_motion_vectors_of_moving_geometry_match_reference(
        cornell_nodes):
    """raster_gbuffer of an animated scene whose camera also moves: K2
    interpolates last frame's positions as an eleventh component and the
    motion vectors project them; against the reference's G-buffer."""
    sj, _ = cornell_nodes
    path = AJ.CameraPath.orbit(center=(0.0, 1.0, 0.0), radius=3.5,
                               height=0.5, duration=4.0)
    aj = AJ.AnimationController(tracks(AJ), dt=0.1).animate(sj, 0.7)
    aj = aj.with_camera(path.camera_at(0.7, sj.camera, dt=0.1))
    st = carry(aj)
    assert st.prev_positions is not None
    table = GT.attribute_table(st)
    assert (table.nci, table.nflat) == (11, 4)
    ref = {k: np.asarray(v) for k, v in GJ.raster_gbuffer(aj, 64, 48).items()}
    got = {k: v.numpy() for k, v in GT.raster_gbuffer(st, 64, 48).items()}
    same = (ref["tri_id"] == got["tri_id"]) & (got["tri_id"] >= 0)
    assert (ref["tri_id"] != got["tri_id"]).mean() <= MAX_ID_MISMATCH
    assert np.abs(ref["mvec"][same]).max() > 1e-2      # they do move
    for k in ("mvec", "posW"):
        np.testing.assert_allclose(got[k][same], ref[k][same],
                                   atol=MVEC_ATOL, rtol=0, err_msg=k)
    # a static scene keeps K2's eight interpolated components
    assert GT.attribute_table(carry(sj)).nci == 8


def test_pixel_centres_are_ieee_divisions():
    """The G-buffer's pixel-centre grid is (arange(n) + 0.5) / n rounded
    once, at every width a frame uses; a multiply by the reciprocal, which
    CUDA substitutes for a division by a Python number, misses it at some
    of them (ROADMAP hazard c)."""
    from test_torch_scene import cuda_scalar_division
    missed = 0
    for n in range(1, 2049):
        want = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
            / np.float32(n)
        with cuda_scalar_division():
            got = GT.pixel_centres(n, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
        recip = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
            * (np.float32(1.0) / np.float32(n))
        missed += int((recip != want).any())
    assert missed > 0


def _animated_renderer(script, width, height, guard_band=None):
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = Renderer(width, height, device="cpu")
    run_script(str(ROOT / script), m)
    if guard_band is not None:
        m.active_graph.get_pass("GuardBand").cfg["guardBand"] = guard_band
    m.loadScene("CornellBox")
    node = np.zeros(m.scene.num_triangles, np.int32)
    node[:8] = 1
    m.scene = dataclasses.replace(m.scene, node_id=torch.as_tensor(node))
    for g in m.graphs:
        g.set_scene(m.scene)
    m.animationController = AT.AnimationController(
        {1: AT.NodeTrack.oscillate((0.0, 1.0, 0.0), amplitude=0.5,
                                   period=1.0)})
    m.cameraPath = AT.CameraPath.orbit(center=(0.0, 1.0, 0.0), radius=3.5,
                                       height=0.5, duration=4.0)
    m.clock.play()
    return m


def test_renderer_animation_does_not_compound():
    """Node tracks are absolute: after frames of an oscillating track the
    renderer's bind pose is untouched and the last frame animated it
    afresh (the counterpart of tests/test_graph.py's
    test_renderer_animation_does_not_compound and tests/test_shading.py's
    test_animation_no_compounding)."""
    m = _animated_renderer("scripts/HBAO.py", 32, 32, guard_band=0)
    pristine = m.scene.positions.clone()
    for _ in range(3):
        m.renderFrame()
    assert torch.equal(m._scene_comp.positions, pristine)
    ctrl = m.animationController
    t_last = m.clock.time - 1.0 / m.clock.framerate
    a, b = (ctrl.animate(m._scene_comp, t_last).positions for _ in range(2))
    assert torch.equal(a, b)
    moved = ctrl.animate(m._scene_comp, 0.25).positions
    assert not torch.allclose(moved[:8], pristine[:8])
    assert torch.equal(moved[8:], pristine[8:])


def test_animated_frame_equals_a_fresh_render():
    """Frame 1 of an animated render equals a fresh renderer's frame 1 of
    the scene animated to that time (scripts/HBAO.py keeps no temporal
    state): nothing the frame reads is left from frame 0."""
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = _animated_renderer("scripts/HBAO.py", 48, 40, guard_band=0)
    m.clock.frame = 0
    m.renderFrame()
    m.clock.frame = 1
    got = m.renderFrame()
    t1 = 1.0 / m.clock.framerate
    base = m._scene_comp.camera
    scene = m.animationController.animate(m._scene_comp, t1).with_camera(
        m.cameraPath.camera_at(t1, base, dt=t1, aspect=float(base.aspect),
                               focal=float(base.focal_length)))
    fresh = Renderer(48, 40, device="cpu")
    run_script(str(ROOT / "scripts" / "HBAO.py"), fresh)
    fresh.active_graph.get_pass("GuardBand").cfg["guardBand"] = 0
    fresh.loadScene("CornellBox")
    fresh.scene = scene
    for g in fresh.graphs:
        g.set_scene(scene)
    fresh.clock.pause()
    fresh.clock.frame = 1
    want = fresh.renderFrame()
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_config5_node_selection_matches_reference():
    """BASELINE config 5's oscillating node (chip_smoke.config5_animation):
    the tallest 2% of EmeraldSquare@full's triangles by centroid height,
    the reference's numpy selection (bench_configs.py:56-60) on the same
    float32 positions."""
    import chip_smoke
    from rtsdm_tpu_torch.mogwai import Renderer
    sj = PJ.load_scene("EmeraldSquare@full", aspect=16 / 9)
    cent = np.asarray(sj.positions).mean(1)
    sel = np.argsort(cent[:, 1])[-len(cent) // 50:]
    want = np.zeros(len(cent), np.int32)
    want[sel] = 1
    m = Renderer(1280, 720, device="cpu")
    m.loadScene("EmeraldSquare@full")
    np.testing.assert_array_equal(m.scene.positions.numpy(),
                                  np.asarray(sj.positions))
    chip_smoke.config5_animation(m)
    assert m.scene.num_triangles == 1036922
    np.testing.assert_array_equal(m.scene.node_id.numpy(), want)
    assert int(want.sum()) == 20739
    assert isinstance(m.animationController, AT.AnimationController)
    assert not m.clock.paused
