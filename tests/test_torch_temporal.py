"""The passes of scripts/SVAO.py that the port adds beside the SD tiers,
each against its rtsdm_tpu counterpart on the CPU on seeded inputs:
TemporalAO, AOFlickerMask, BinaryDilation, AccumulatePass, DepthPass,
RayMinMaxLength, DLSSPass, PathBenchmark and the profiler.

Tolerances (float32):
  TemporalAO: 1e-6 absolute on the AO, exact on the history counts. The
    reference's CPU path fetches the history by truncating the position,
    the port by K10's nearest mode (floor, then the clamp), which agree at
    every position (test below); the 4x4 inverse of the previous view is
    torch.linalg.inv_ex's against XLA's, which may differ in the last bits
    (held to 1e-6); the reprojected depth only feeds a relative test at
    0.1, so the accept masks agree exactly on these inputs;
  AOFlickerMask: the mask is compared exactly (its plane differences are
    float32 sums that XLA may fuse; on these inputs no pixel flips);
  DepthPass: the reference's CPU raster is its XLA tier, which differs from
    the Pallas raster the port follows on edge pixels (hazard f,
    tests/test_torch_raster.py): at most 1e-3 of the pixels may differ,
    the rest agree to 2e-5;
  BinaryDilation, AccumulatePass, RayMinMaxLength, DLSSPass: exact.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.core import profiler as PRJ  # noqa: E402
from rtsdm_tpu.passes import gbuffer as GJ  # noqa: E402
from rtsdm_tpu.passes import pipeline_misc as MJ  # noqa: E402
from rtsdm_tpu.passes import stubs as SJ  # noqa: E402
from rtsdm_tpu.passes import temporal as TJ  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RCJ  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu.scene.camera import Camera as CamJ  # noqa: E402
from rtsdm_tpu_torch.core import profiler as PRT  # noqa: E402
from rtsdm_tpu_torch.ops.warp_cuda import warp_resample_plain  # noqa: E402
from rtsdm_tpu_torch.passes import gbuffer as GT  # noqa: E402
from rtsdm_tpu_torch.passes import measure as MST  # noqa: E402
from rtsdm_tpu_torch.passes import pipeline_misc as MT  # noqa: E402
from rtsdm_tpu_torch.passes import stubs as ST  # noqa: E402
from rtsdm_tpu_torch.passes import temporal as TT  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402
from rtsdm_tpu_torch.scene.camera import Camera as CamT  # noqa: E402

H, W, G = 24, 40, 2


def _both(cls_j, cls_t, props):
    return cls_j(dict(props)), cls_t(dict(props))


def _ctx(scene_j, scene_t, w=W, h=H, guard=G):
    return (RCJ(width=w, height=h, scene=scene_j,
                dictionary={"guardBand": guard}),
            RenderContext(width=w, height=h, scene=scene_t,
                          dictionary={"guardBand": guard}))


def _exec(pj, pt, cj, ct, inputs, state=(None, None)):
    oj, nj = pj.execute(cj, {k: jnp.asarray(v) for k, v in inputs.items()},
                        state[0])
    ot, nt = pt.execute(ct, {k: torch.as_tensor(v) for k, v in
                             inputs.items()}, state[1])
    return ({k: np.asarray(v) for k, v in oj.items()},
            {k: v.numpy() for k, v in ot.items()}, (nj, nt))


@pytest.fixture(scope="module")
def cornell():
    sj = PJ.cornell_box(aspect=W / H)
    return sj, carry(sj)


def _moved_camera(sj, st, dx):
    """Both packages' scenes with the camera moved dx along x."""
    kw = dict(position=(0.0 + dx, 1.0, 3.9), target=(0.0, 1.0, 0.0),
              focal_length=21.0, frame_height=24.0, aspect=W / H,
              near_z=0.1, far_z=100.0)
    return (sj.with_camera(CamJ.create(**kw)),
            st.with_camera(CamT.create(**kw, device="cpu")))


def test_nearest_floor_equals_truncation_after_the_clamp():
    """K10's nearest mode takes floor(p) and clamps; the reference's CPU
    TemporalAO truncates and clamps (rtsdm_tpu/passes/temporal.py:208-209).
    They differ before the clamp only on (-1, 0), where both give 0."""
    w = 7
    tex = torch.arange(w, dtype=torch.float32)[None, None, :]
    xs = np.float32([-5.2, -1.0, -0.99, -0.5, -1e-7, -0.0, 0.0, 0.3, 3.5,
                     w - 1.2, w - 1.0, w - 0.5, w - 1e-6, w, w + 0.4, 1e9])
    got = warp_resample_plain(tex, torch.as_tensor(xs)[None],
                              torch.zeros((1, len(xs))), "nearest")[0, 0]
    want = np.clip(xs.astype(np.int32), 0, w - 1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_temporal_ao_two_frames_with_motion(cornell):
    """TemporalAO enabled over two frames with a moving camera, a motion
    field of up to +-3 px and a stable mask: the second frame reprojects,
    rejects, merges and counts history as the reference does."""
    sj, st = cornell
    rng = np.random.default_rng(21)
    pj, pt = _both(TJ.TemporalAO, TT.TemporalAO,
                   dict(enabled=True, useStableMask=True))
    cj, ct = _ctx(sj, st)
    state = (pj.init_state(cj), pt.init_state(ct))
    accepted = 0
    for f, dx in enumerate((0.0, 0.05)):
        sjf, stf = _moved_camera(sj, st, dx)
        cj, ct = _ctx(sjf, stf)
        depth = (3.0 + np.cumsum(rng.uniform(0, 0.02, (H, W)), 1)
                 ).astype(np.float32)
        inputs = {
            "aoIn": rng.uniform(0, 1, (H, W)).astype(np.float32),
            "linearZ": depth,
            "mvec": (rng.uniform(-3, 3, (H, W, 2))
                     / np.asarray([W, H])).astype(np.float32),
            "stableMask": (rng.uniform(0, 1, (H, W)) < 0.2).astype(np.int32)}
        oj, ot, (nj, nt) = _exec(pj, pt, cj, ct, inputs, state)
        np.testing.assert_allclose(ot["aoOut"], oj["aoOut"], atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(nt["history"].numpy(),
                                      np.asarray(nj["history"]))
        np.testing.assert_array_equal(nt["prev_ao"].numpy(),
                                      np.asarray(nj["prev_ao"]))
        state = (nj, nt)
        if f:
            accepted = int((np.asarray(nj["history"]) == 2).sum())
    assert 0 < accepted < H * W            # some merged, some rejected
    np.testing.assert_allclose(
        torch.linalg.inv_ex(torch.as_tensor(np.asarray(
            sjf.camera.view_mat))).inverse.numpy(),
        np.asarray(jnp.linalg.inv(sjf.camera.view_mat)), atol=1e-6)


def test_temporal_ao_disabled_passes_through(cornell):
    sj, st = cornell
    ao = np.random.default_rng(2).uniform(0, 1, (H, W, 1)).astype(np.float32)
    z = np.ones((H, W), np.float32)
    pt = TT.TemporalAO(dict(enabled=False))
    _, ct = _ctx(sj, st)
    out, state = pt.execute(ct, {"aoIn": torch.as_tensor(ao),
                                 "linearZ": torch.as_tensor(z),
                                 "mvec": torch.zeros((H, W, 2))}, "s")
    assert state == "s"
    np.testing.assert_array_equal(out["aoOut"].numpy(), ao[..., 0])


def test_ao_flicker_mask(cornell):
    """Planes of two slopes meeting at a crease, with world normals: the
    crease and the slope changes are unstable, the planes stable."""
    sj, st = cornell
    xs = np.arange(W, dtype=np.float32)
    z = (3.0 + np.where(xs < W // 2, 0.01 * xs, 0.2 + 0.08 * (xs - W // 2))
         )[None, :].repeat(H, 0).astype(np.float32)
    rng = np.random.default_rng(3)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[:, :, 2] += 4.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pj, pt = _both(TJ.AOFlickerMask, TT.AOFlickerMask, {})
    cj, ct = _ctx(sj, st)
    oj, ot, _ = _exec(pj, pt, cj, ct, {"linearZ": z, "normalW": n})
    assert ot["mask"].dtype == np.int32
    np.testing.assert_array_equal(ot["mask"], oj["mask"].astype(np.int32))
    assert 0 < ot["mask"].sum() < H * W


@pytest.mark.parametrize("op", ["min", "max"])
def test_binary_dilation(op):
    rng = np.random.default_rng(5)
    mask = (rng.uniform(0, 1, (H, W)) < 0.8).astype(np.int32)
    pj, pt = _both(TJ.BinaryDilation, TT.BinaryDilation, {"op": op})
    cj, ct = _ctx(None, None)
    oj, ot, _ = _exec(pj, pt, cj, ct, {"input": mask})
    np.testing.assert_array_equal(ot["output"], oj["output"])


@pytest.mark.parametrize("max_frames", [0, 2])
def test_accumulate_pass(max_frames):
    rng = np.random.default_rng(7)
    pj, pt = _both(TJ.AccumulatePass, TT.AccumulatePass,
                   dict(enabled=True, autoReset=True,
                        maxFrameCount=max_frames))
    cj, ct = _ctx(None, None)
    state = (pj.init_state(cj), pt.init_state(ct))
    for _ in range(3):
        x = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
        oj, ot, state = _exec(pj, pt, cj, ct, {"input": x}, state)
        np.testing.assert_array_equal(ot["output"], oj["output"])


def test_depth_pass(cornell):
    sj, st = cornell
    pj, pt = _both(GJ.DepthPass, GT.DepthPass, dict(cullMode="Back"))
    cj, ct = _ctx(sj, st, w=64, h=48)
    oj, ot, _ = _exec(pj, pt, cj, ct, {})
    got, want = ot["depth"], oj["depth"]
    same = np.abs(got - want) <= 2e-5
    assert (~same).mean() <= 1e-3
    assert got.shape == (48, 64) and (got < 1.0).any()
    np.testing.assert_array_equal(
        got, GT.raster_gbuffer(st, 64, 48)["depth"].numpy())


def test_ray_min_max_length():
    rng = np.random.default_rng(9)
    rmin = rng.uniform(0, 5, (H, W)).astype(np.float32)
    rmax = (rmin + rng.uniform(-1, 5, (H, W))).astype(np.float32)
    rmin[::3] = 3.4028235e38          # the FLT_MAX clear
    rmax[::5] = 0.0                   # not requested
    pj, pt = _both(MJ.RayMinMaxLength, MT.RayMinMaxLength, {})
    cj, ct = _ctx(None, None)
    oj, ot, _ = _exec(pj, pt, cj, ct, {"kRayMin": rmin, "kRayMax": rmax})
    np.testing.assert_array_equal(ot["length"], oj["length"])


def test_dlss_pass_is_its_input():
    rng = np.random.default_rng(11)
    color = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    pj, pt = _both(SJ.DLSSPass, ST.DLSSPass, dict(profile="Balanced"))
    assert set(pt.SCHEMA) == set(pj.SCHEMA)
    cj, ct = _ctx(None, None)
    oj, ot, _ = _exec(pj, pt, cj, ct, {"color": color})
    np.testing.assert_array_equal(ot["output"], color)
    np.testing.assert_array_equal(ot["output"], oj["output"])


def _scopes(prof):
    with prof.event("frame"):
        with prof.event("A"):
            pass
        with prof.event("B"):
            with prof.event("C"):
                pass
    with prof.event("frame"):
        with prof.event("A"):
            pass
    return prof


def test_profiler_tree_matches_reference():
    """The same scopes give the same tree, counts and flat keys in both
    packages; a disabled profiler records nothing; profile_scope opens on
    the active profiler only."""
    def shape(cap):
        return (cap["name"], cap["count"],
                [shape(c) for c in cap["children"]])

    pt = _scopes(PRT.Profiler())
    pj = _scopes(PRJ.Profiler())
    assert shape(pt.capture()) == shape(pj.capture())
    assert sorted(pt.flat_averages()) == sorted(pj.flat_averages()) == [
        "frame", "frame/A", "frame/B", "frame/B/C"]
    assert json.loads(pt.capture_json())["children"][0]["count"] == 2
    pt.reset()
    assert pt.capture()["children"] == []
    off = _scopes(PRT.Profiler(enabled=False))
    assert off.flat_averages() == {}
    with PRT.profile_scope("x"):
        pass
    with off.activate(), PRT.profile_scope("x"):
        pass
    assert off.flat_averages() == {}
    with pt.activate(), PRT.profile_scope("x"):
        pass
    assert pt.flat_averages() == {"x": pytest.approx(
        pt.capture()["children"][0]["avg_ms"])}


def test_path_benchmark_rows_need_the_profiler():
    pt = MST.PathBenchmark({})
    ctx = RenderContext(width=4, height=4)
    pt.execute(ctx, {})
    assert pt.rows == [] and pt.csv() == ""
    ctx.profiler = _scopes(PRT.Profiler())
    pt.execute(ctx, {})
    pt.execute(ctx, {})
    lines = pt.csv().splitlines()
    assert lines[0] == "frame,frame,frame/A,frame/B,frame/B/C"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["0", "1"]
