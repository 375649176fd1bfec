"""Parity of the port's visibility raster (K1), attribute fetch (K2) and
G-buffer with rtsdm_tpu on the CPU; the kernels' own checks against their
plain versions run on a GPU only (tests/test_torch_cuda.py).

Reference: the Pallas drivers rasterize_pallas / fetch_attributes_pallas in
interpret mode, on the same scene arrays and camera (scene_from_numpy).

Tolerances and why: XLA:CPU contracts a*b+c into fused multiply-adds
(measured in this environment: jit(a*b+c) equals the fused result on 100%
of random inputs, the separately rounded one on 77%), while PyTorch rounds
every operation — and the CUDA kernels are built with --fmad=false to
match PyTorch. Edge functions that land exactly on a pixel centre, and
coplanar ties, can therefore resolve differently: tri_id may differ on at
most 0.1% of pixels (measured: 2 of 4096 on CornellBox 64x64, 0 of 6144 on
Arcade 96x64); where the ids agree, NDC depth agrees to 2e-5 and the
barycentrics to 2e-4 (relative error of nearly cancelling edge sums).
Flat attributes gathered by an agreed id are bit-exact.
"""
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
from test_pallas_interpret import interpret_mode  # noqa: E402
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.ops import raster_pallas as rpx  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu_torch.ops import raster as R  # noqa: E402
from rtsdm_tpu_torch.ops import raster_cuda as RC  # noqa: E402

MAX_ID_MISMATCH = 1e-3


@pytest.fixture(scope="module", params=[("CornellBox", 64, 64),
                                        ("Arcade", 96, 64)])
def raster_pair(request):
    name, w, h = request.param
    sj = PJ.load_scene(name, aspect=w / h)
    st = carry(sj)
    vp = sj.camera.view_proj_mat
    with interpret_mode(rpx):
        ref = rpx.rasterize_pallas(vp, sj.positions, width=w, height=h)
    got = R.rasterize(st.camera.view_proj_mat, st.positions, width=w,
                      height=h)
    return dict(sj=sj, st=st, w=w, h=h,
                ref={k: np.asarray(v) for k, v in ref.items()},
                got={k: v.numpy() for k, v in got.items()})


def test_rasterize_matches_pallas_interpret(raster_pair):
    ref, got = raster_pair["ref"], raster_pair["got"]
    same = ref["tri_id"] == got["tri_id"]
    assert (~same).mean() <= MAX_ID_MISMATCH
    assert (ref["tri_id"] >= 0).any()
    np.testing.assert_allclose(got["depth"][same], ref["depth"][same],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["bary"][same], ref["bary"][same],
                               atol=2e-4, rtol=0)
    assert int(got["overflow"]) == int(ref["overflow"]) == 0


def test_rasterize_with_floor_matches_pallas_interpret(raster_pair):
    """K1 with its depth floor (depth peeling): the first layer's linear
    depth as the floor, min_separation 0.5, against rasterize_pallas with
    the same floor. The id bound is the one without a floor (measured: 0
    of 4096 ids differ on CornellBox, 2 of 6144 on Arcade); where the ids
    agree NDC depth agrees to 5e-5 (measured max 2.8e-5 on Arcade: the
    second layer holds more grazing surfaces than the first, whose bound
    is 2e-5)."""
    sj, st, w, h = (raster_pair[k] for k in ("sj", "st", "w", "h"))
    lin = st.camera.linearize_depth(torch.as_tensor(
        raster_pair["got"]["depth"]))
    with interpret_mode(rpx):
        ref = rpx.rasterize_pallas(sj.camera.view_proj_mat, sj.positions,
                                   width=w, height=h,
                                   depth_floor=jnp.asarray(lin.numpy()),
                                   min_separation=0.5)
    got = R.rasterize(st.camera.view_proj_mat, st.positions, width=w,
                      height=h, depth_floor=lin, min_separation=0.5)
    rid, gid = np.asarray(ref["tri_id"]), got["tri_id"].numpy()
    same = rid == gid
    assert (~same).mean() <= MAX_ID_MISMATCH
    # the floor removed the first layer and left a second one
    assert (rid != raster_pair["ref"]["tri_id"]).mean() > 0.5
    assert (rid >= 0).any()
    np.testing.assert_allclose(got["depth"].numpy()[same],
                               np.asarray(ref["depth"])[same], atol=5e-5,
                               rtol=0)


def test_setup_triangles_matches_reference(raster_pair):
    from rtsdm_tpu.ops import raster as RJ
    sj, st, w, h = (raster_pair[k] for k in ("sj", "st", "w", "h"))
    cj, bj, vj = RJ._setup_triangles(sj.camera.view_proj_mat, sj.positions,
                                     w, h, jnp.float32(0), jnp.float32(0),
                                     RJ.CULL_BACK)
    ct, bt, vt = R._setup_triangles(st.camera.view_proj_mat, st.positions,
                                    w, h, 0.0, 0.0, R.CULL_BACK)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # the coefficients are cross products of homogeneous pixel coordinates
    # that cancel by up to ~4 decimal digits, so a last-bit difference of
    # the fused products shows up at ~1e-4 of the triangle's largest
    # coefficient (measured max 3.8e-4 on Arcade, 7.2e-4 on SunTemple)
    cj = np.asarray(cj)
    scale = np.abs(cj).max(axis=(1, 2))[:, None, None]
    assert (np.abs(ct.numpy() - cj) <= 2e-3 * scale).all()


def test_fetch_attributes_matches_pallas_interpret(raster_pair):
    """Same winner image in, same attributes out (K2 plain version vs the
    one-hot Pallas fetch)."""
    sj, st, ref = raster_pair["sj"], raster_pair["st"], raster_pair["ref"]
    tid, bary = ref["tri_id"], ref["bary"]
    with interpret_mode(rpx):
        want = rpx.fetch_attributes_pallas(
            jnp.asarray(tid), jnp.asarray(bary),
            [sj.positions, sj.normals, sj.texcoords],
            [sj.face_normals(), sj.material_id])
    got = R.fetch_vertex_attributes(
        torch.as_tensor(np.array(tid)), torch.as_tensor(np.array(bary)),
        [st.positions, st.normals, st.texcoords],
        [torch.as_tensor(np.array(sj.face_normals())), st.material_id])
    for g, wnt in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[4].dtype == torch.int32
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_tie_breaks_match_pallas_interpret():
    """Coplanar duplicates: within a chunk the lowest lane wins, and a
    later chunk never replaces an equally close hit."""
    tri = np.array([[[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0]]],
                   np.float32)
    filler = np.tile(np.array([[[50.0, 50.0, -5.0], [51.0, 50.0, -5.0],
                                [50.0, 51.0, -5.0]]], np.float32),
                     (128, 1, 1))
    pos = np.concatenate([tri, tri, filler, tri])   # ids 0, 1 and 130
    from rtsdm_tpu.scene.camera import Camera as CJ
    cam = CJ.create(position=(0.5, 0.5, 3.0), target=(0.5, 0.5, 0.0))
    vp = cam.view_proj_mat
    with interpret_mode(rpx):
        ref = np.asarray(rpx.rasterize_pallas(vp, jnp.asarray(pos), width=32,
                                              height=32)["tri_id"])
    got = R.rasterize(torch.as_tensor(np.array(vp)), torch.as_tensor(pos),
                      width=32, height=32)["tri_id"].numpy()
    assert set(np.unique(ref)) == {-1, 0}
    np.testing.assert_array_equal(got, ref)


def test_list_overflow_streams_every_chunk():
    """A tile whose overlap count exceeds its list width walks all chunks
    in order: same image as with complete lists."""
    sj = PJ.arcade()
    st = carry(sj)
    w, h = 64, 32
    coef, bbox, valid = R._setup_triangles(st.camera.view_proj_mat,
                                           st.positions, w, h, 0.0, 0.0,
                                           R.CULL_BACK)
    order = RC.screen_morton_order(bbox, valid, w, h)
    chunks = RC.pack_coef_chunks(coef[order], valid[order], order)
    lists, counts = RC.build_chunk_lists_2d(
        RC.chunk_screen_bboxes(bbox[order], valid[order]), 4, 2)
    assert int(counts.max()) > 2
    full = RC.raster_blocks(chunks, lists, counts, 4, 2)
    short = RC.raster_blocks(chunks, lists[:, :2].contiguous(), counts, 4, 2)
    for a, b in zip(full, short):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gbuffer_matches_reference():
    """raster_gbuffer channels against rtsdm_tpu's CPU G-buffer."""
    from rtsdm_tpu.passes.gbuffer import raster_gbuffer as gb_j
    from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer as gb_t
    sj = PJ.cornell_box()
    ref = {k: np.asarray(v) for k, v in gb_j(sj, 64, 64).items()}
    got = {k: v.numpy() for k, v in gb_t(carry(sj), 64, 64).items()}
    same = ref["tri_id"] == got["tri_id"]
    assert (~same).mean() <= MAX_ID_MISMATCH
    np.testing.assert_allclose(got["depth"][same], ref["depth"][same],
                               atol=2e-5)
    np.testing.assert_array_equal(got["mtlData"][same], ref["mtlData"][same])
    np.testing.assert_allclose(got["faceNormalW"][same],
                               ref["faceNormalW"][same], atol=1e-6)
    for k in ("posW", "normW", "texC", "mvec"):
        np.testing.assert_allclose(got[k][same], ref[k][same], atol=2e-4,
                                   err_msg=k)
