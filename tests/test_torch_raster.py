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
from test_torch_cuda import (ADV_H, ADV_W, EYE_H, EYE_W,  # noqa: E402
                             adversarial_floor, adversarial_scene,
                             eye_scene, parent_bins)
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
    boxes = RC.pack_tri_boxes(bbox[order], valid[order])
    assert int(counts.max()) > 2
    full = RC.raster_blocks(chunks, boxes, lists, counts, 4, 2)
    short = RC.raster_blocks(chunks, boxes, lists[:, :2].contiguous(),
                             counts, 4, 2)
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


def test_gbuffer_table_cache_follows_in_place_edits():
    """The G-buffer's attribute table is kept per scene geometry (a frame's
    jittered scene shares it) and built anew after an in-place edit of the
    positions or material ids: the G-buffer then equals one built from
    fresh copies of the edited tensors, which miss the cache, and one built
    from inference-mode copies, which keep no version and are never
    kept."""
    import dataclasses
    from rtsdm_tpu_torch.passes.gbuffer import attribute_table, raster_gbuffer
    st = carry(PJ.cornell_box())
    before = raster_gbuffer(st, 48, 48)
    assert attribute_table(st.with_camera(st.camera)) is attribute_table(st)
    st.positions[:, :, 1].add_(0.05)
    st.material_id[::2] = 1 - st.material_id[::2]
    got = raster_gbuffer(st, 48, 48)
    def copied(scene):
        return dataclasses.replace(scene, **{
            k: getattr(scene, k).clone()
            for k in ("positions", "normals", "texcoords", "material_id")})

    want = raster_gbuffer(copied(st), 48, 48)
    with torch.inference_mode():    # tensors that keep no version
        unkept = raster_gbuffer(copied(st), 48, 48)
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(unkept[k], v), k
    assert not torch.equal(got["posW"], before["posW"])
    assert not torch.equal(got["mtlData"], before["mtlData"])


# --- K1's per-triangle cull (csrc/raster.cu) ------------------------------

@pytest.fixture(scope="module", params=["CornellBox 64x64", "Arcade 96x64",
                                        "adversarial 70x45"])
def cull_case(request):
    """K1's inputs (chunks, boxes, lists, counts, nby, nbx) and the first
    layer's view depth as a depth floor, on a scene of the package and on
    the adversarial scene (tests/test_torch_cuda.py: adversarial_scene)."""
    from rtsdm_tpu_torch.scene.procedural import load_scene
    name = request.param.split()[0]
    if name == "adversarial":
        vp, pos = adversarial_scene()
        args = R._binned_chunks(torch.as_tensor(vp), torch.as_tensor(pos),
                                ADV_W, ADV_H, 0.0, 0.0, "none")[0]
        to_floor = adversarial_floor
    else:
        w, h = map(int, request.param.split()[1].split("x"))
        st = load_scene(name, aspect=w / h, device="cpu")
        args = R._binned_chunks(st.camera.view_proj_no_jitter, st.positions,
                                w, h, 0.0, 0.0, "back")[0]

        def to_floor(z):
            return st.camera.linearize_depth(z).contiguous()
    z = RC.raster_blocks_plain(args[0], None, *args[2:])[0]
    return args, to_floor(z)


def test_cull_keeps_every_accepted_pair(cull_case):
    """At every visit of every tile's walk, each lane whose triangle the
    fragment test accepts at some pixel of a half tile (padding pixels
    included, without and with the floor) survives K1's cull for that
    half; the cull drops lanes; and cull_survivors counts the survivors of
    the walk."""
    (chunks, boxes, lists, counts, nby, nbx), floor = cull_case
    nb = nby * nbx
    px, py = RC.tile_centres(nb, nbx, 0.5, 0.5, chunks.device)
    fl = (RC.tile_flatten(floor) + 0.5).reshape(nb, RC.RB)
    survivors = valid = 0
    counted = RC.cull_survivors(boxes, lists, counts, nbx)
    for j, rows, ci in RC.tile_walk(lists, counts, chunks.shape[0], 64):
        keep = RC.lane_survivors(boxes, ci, rows, nbx)
        tri = chunks[ci][:, :, None, :]
        x, y = px[rows][:, :, None], py[rows][:, :, None]
        for f in (None, fl[rows][:, :, None]):
            inside = RC.fragments(tri, x, y, f)[0]      # pixels 0-127: rows 0-3
            inside = inside.reshape(len(rows), 2, RC.RB // 2, RC.TC).any(2)
            assert not bool((inside & ~keep).any()), j
        assert torch.equal(counted[rows, j],
                           keep.sum(-1, dtype=torch.int32))
        survivors += int(keep.sum())
        valid += 2 * int((chunks[ci, 15] > 0).sum())
    assert 0 < survivors < valid
    assert int(counted.clamp(min=0).sum()) == survivors


@pytest.mark.parametrize("floored", [False, True])
def test_culled_plain_raster_equals_unrestricted(cull_case, floored):
    """The plain raster restricted to the cull's survivors equals the
    unrestricted one bit for bit, padding pixels included, plain and with
    the first layer as a depth floor (min_separation 0.5), with complete
    lists and with lists of width 2 that stream every chunk."""
    (chunks, boxes, lists, counts, nby, nbx), floor = cull_case
    kw = dict(floor=floor, min_separation=0.5) if floored else {}
    for ls in (lists, lists[:, :2].contiguous()):
        want = RC.raster_blocks_plain(chunks, None, ls, counts, nby, nbx,
                                      **kw)
        got = RC.raster_blocks_plain(chunks, boxes, ls, counts, nby, nbx,
                                     **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool((want[1] >= 0).any())


def test_pack_tri_boxes_layout():
    """pack_tri_boxes puts triangle t's box at [t // 128, :, t % 128] and
    an empty box, which overlaps no tile, on invalid and padding lanes."""
    bbox = torch.tensor([[0.0, 0.0, 5.0, 3.0], [2.0, 1.0, 40.0, 9.0],
                         [1.0, 1.0, 2.0, 2.0]])
    boxes = RC.pack_tri_boxes(bbox, torch.tensor([True, True, False]))
    assert boxes.shape == (1, 4, RC.TC) and boxes.is_contiguous()
    np.testing.assert_array_equal(boxes[0, :, :2].T.numpy(), bbox[:2])
    keep = RC.lane_survivors(boxes, torch.zeros(2, dtype=torch.long),
                             torch.tensor([0, 1]), 2)
    assert keep.shape == (2, 2, RC.TC) and keep[..., 2:].sum() == 0
    # tile 0 (x in [0, 32)): rows 0-3 and rows 4-7; tile 1 (x in [32, 64))
    assert keep[0, :, :2].tolist() == [[True, True], [False, True]]
    assert keep[1, :, :2].tolist() == [[False, True], [False, True]]


def test_raster_blocks_checks_tri_boxes():
    """K1's wrapper refuses triangle boxes of another shape, type or
    device than the chunks' (ValueError, TypeError), and pixel centres
    outside the unit offsets the boxes bound, before any dispatch."""
    chunks = torch.zeros((2, RC.COEF_ROWS, RC.TC))
    lists = torch.zeros((1, 1), dtype=torch.int32)
    counts = torch.ones((1,), dtype=torch.int32)
    good = torch.zeros((2, 4, RC.TC))
    assert RC.raster_blocks(chunks, good, lists, counts, 1, 1)[1].shape \
        == (8, 32)
    for bad in (torch.zeros((1, 4, RC.TC)), torch.zeros((2, 5, RC.TC)),
                torch.zeros((2, 4, 64)), good.to("meta")):
        with pytest.raises(ValueError, match="tri_boxes"):
            RC.raster_blocks(chunks, bad, lists, counts, 1, 1)
    with pytest.raises(ValueError, match="px0 and py0"):
        RC.raster_blocks(chunks, good, lists, counts, 1, 1, px0=1.5)
    with pytest.raises(TypeError, match="tri_boxes"):
        RC.raster_blocks(chunks, good.double(), lists, counts, 1, 1)
    with pytest.raises(ValueError, match="tri_boxes must be contiguous"):
        RC.raster_blocks(chunks, good.transpose(1, 2).contiguous()
                         .transpose(1, 2), lists, counts, 1, 1)


# --- the binning's eye-plane cull (ops/raster._binned_chunks) ----------------

def test_eye_culled_triangles_are_never_accepted():
    """The triangles behind_eye culls with the eye among EmeraldSquare's
    buildings, without a face cull (a superset of the back-face cull's,
    with the same coefficients), rasterized alone by K1's plain version
    with every tile listing every chunk and no cull boxes, leave the image
    empty: K1's own fragment test holds the claim that it never accepts
    them. K9's test (e_i >= 0 where K1's allows -1e-5 of the sum) accepts
    no fragment K1's rejects, so the claim holds for K9 too."""
    st = eye_scene(True, "cpu")
    coef, _, valid, w = R._setup_with_w(st.camera.view_proj_no_jitter,
                                        st.positions, EYE_W, EYE_H, 0.0, 0.0,
                                        R.CULL_NONE)
    culled = valid & RC.behind_eye(coef, w, EYE_W, EYE_H)
    ids = torch.nonzero(culled).squeeze(1)
    assert ids.numel() > 3000
    chunks = RC.pack_coef_chunks(coef[ids], torch.ones_like(ids, dtype=bool),
                                 ids)
    nby, nbx = EYE_H // RC.TILE_RH, EYE_W // RC.TILE_RW
    n = chunks.shape[0]
    lists = torch.arange(n, dtype=torch.int32).repeat(nby * nbx, 1)
    counts = torch.full((nby * nbx,), n, dtype=torch.int32)
    z, tid, _, _ = RC.raster_blocks_plain(chunks, None, lists, counts, nby,
                                          nbx)
    assert bool((tid == -1).all()) and bool((z == 1.0).all())
    # a degenerate triangle behind the eye (its third vertex on its first
    # edge) lies within the rounding bound and is left to K1's test
    tri = st.positions[ids[:1]].clone()
    tri[0, 2] = 0.5 * (tri[0, 0] + tri[0, 1])
    coef, _, _, w = R._setup_with_w(st.camera.view_proj_no_jitter, tri,
                                    EYE_W, EYE_H, 0.0, 0.0, R.CULL_NONE)
    assert (w < 0).all() and not bool(RC.behind_eye(coef, w, EYE_W,
                                                    EYE_H).any())


@pytest.mark.parametrize("inside", [True, False], ids=["eye inside",
                                                       "eye outside"])
def test_eye_cull_keeps_the_raster_and_the_other_chunks(inside):
    """With the eye among EmeraldSquare's buildings and outside the town:
    rasterize's tri_id, depth and bary equal bit for bit K1's on the
    binning without the cull (parent_bins), and its eye_culled counts
    behind_eye's triangles. Every chunk outside the viewport centre's
    morton key group holds the parent's triangles, boxes and valid lanes;
    within the group the culled triangles sort behind the others, each
    part in the parent's order, and leave the valid lanes and the lists;
    where nothing is culled the binning is the parent's."""
    st = eye_scene(inside, "cpu")
    vp, pos = st.camera.view_proj_no_jitter, st.positions
    out = R.rasterize(vp, pos, width=EYE_W, height=EYE_H)
    base = parent_bins(vp, pos, EYE_W, EYE_H)
    z, tid, b1, b2 = RC.raster_blocks(*base)
    assert torch.equal(out["tri_id"], tid) and torch.equal(out["depth"], z)
    assert torch.equal(out["bary"], torch.stack([b1, b2], -1))
    assert bool((tid >= 0).any())

    coef, bbox, valid, w = R._setup_with_w(vp, pos, EYE_W, EYE_H, 0.0, 0.0,
                                           R.CULL_BACK)
    culled = valid & RC.behind_eye(coef, w, EYE_W, EYE_H)
    assert int(out["eye_culled"]) == int(culled.sum())
    bins, _ = R._binned_chunks(vp, pos, EYE_W, EYE_H, 0.0, 0.0, "back")
    if not inside:
        assert not bool(culled.any())
        for a, b in zip(bins, base):
            assert a == b if isinstance(a, int) else torch.equal(a, b)
        return
    assert int(culled.sum()) > 1000
    t = coef.shape[0]
    new_ids = bins[0][:, 16].reshape(-1)[:t].long()
    old_ids = base[0][:, 16].reshape(-1)[:t].long()
    centre = RC.screen_morton_key(torch.tensor([[0.0, 0.0, EYE_W, EYE_H]]),
                                  EYE_W, EYE_H)
    group = valid & (RC.screen_morton_key(bbox, EYE_W, EYE_H) == centre)
    assert bool(group[culled].all())
    at = group[old_ids]                  # the group's positions, contiguous
    assert torch.equal(at, group[new_ids])
    assert torch.equal(new_ids[~at], old_ids[~at])
    members = old_ids[at]
    assert torch.equal(new_ids[at], torch.cat([members[~culled[members]],
                                               members[culled[members]]]))
    live = bins[0][:, 15].reshape(-1)[:t] > 0
    assert torch.equal(live, (valid & ~culled)[new_ids])
    whole = ~torch.nn.functional.pad(at, (0, (-t) % RC.TC)).reshape(
        -1, RC.TC).any(1)                # chunks with no member of the group
    assert bool(whole.sum() > 0)
    for a, b in zip(bins[:2], base[:2]):
        assert torch.equal(a[whole], b[whole])
    # the lists then walk a fraction of the chunks
    assert int(bins[3].sum()) * 4 < int(base[3].sum())


# EmeraldSquare with the eye among its buildings (eye_scene's view)
EYE_INSIDE = dict(position=(0.0, 1.7, 0.0), target=(10.0, 1.0, 4.0),
                  focal_length=21.0, aspect=EYE_W / EYE_H, near_z=0.1,
                  far_z=500.0)


@pytest.mark.parametrize("floored", [False, True], ids=["plain", "floored"])
def test_rasterize_eye_inside_matches_pallas_interpret(floored):
    """rasterize with the eye among EmeraldSquare's buildings, where the
    binning culls the triangles wholly behind the eye, against
    rasterize_pallas on the same arrays and camera, plain and with the
    first layer as a depth floor (min_separation 0.5): none of the culled
    triangles is seen by the reference, and the ids differ within
    MAX_ID_MISMATCH (measured: 0 of 12,288, both). Where the ids agree the
    floored depth keeps its bound of 5e-5 (measured 3.8e-5); the plain
    depth and the barycentrics keep the module's bounds except on the side
    faces of thin posts 20-35 units away, seen nearly edge-on (plain: 33
    and 9 pixels, up to 6.3e-5 and 6.4e-4, 1.1e-4 and 3.3e-4 without XLA's
    FMA contraction; floored barycentrics up to 6.1e-4): the set-up
    coefficients differ by up to 2e-3 of their scale
    (test_setup_triangles_matches_reference), and such slivers carry that
    into both. The port's raster there equals K1's without the cull
    bit for bit (test_eye_cull_keeps_the_raster_and_the_other_chunks)."""
    from rtsdm_tpu.scene.camera import Camera as CameraJ
    sj = PJ.emerald_square(aspect=EYE_W / EYE_H).with_camera(
        CameraJ.create(**EYE_INSIDE))
    st = carry(sj)
    vp = st.camera.view_proj_mat
    kw, kwj = {}, {}
    if floored:
        lin = st.camera.linearize_depth(R.rasterize(
            vp, st.positions, width=EYE_W, height=EYE_H)["depth"])
        kw = dict(depth_floor=lin, min_separation=0.5)
        kwj = dict(depth_floor=jnp.asarray(lin.numpy()), min_separation=0.5)
    with interpret_mode(rpx):
        ref = rpx.rasterize_pallas(sj.camera.view_proj_mat, sj.positions,
                                   width=EYE_W, height=EYE_H, **kwj)
    got = R.rasterize(vp, st.positions, width=EYE_W, height=EYE_H, **kw)
    coef, _, valid, w = R._setup_with_w(vp, st.positions, EYE_W, EYE_H, 0.0,
                                        0.0, R.CULL_BACK)
    culled = torch.nonzero(valid & RC.behind_eye(coef, w, EYE_W, EYE_H))
    assert int(got["eye_culled"]) == culled.numel() > 1000
    rid, gid = np.asarray(ref["tri_id"]), got["tri_id"].numpy()
    assert (rid >= 0).any()
    assert not np.isin(rid, culled.numpy()).any()
    same = rid == gid
    assert (~same).mean() <= MAX_ID_MISMATCH
    depth_tol, bary_tol = (5e-5, 1.5e-3) if floored else (1.5e-4, 1.5e-3)
    np.testing.assert_allclose(got["depth"].numpy()[same],
                               np.asarray(ref["depth"])[same],
                               atol=depth_tol, rtol=0)
    np.testing.assert_allclose(got["bary"].numpy()[same],
                               np.asarray(ref["bary"])[same], atol=bary_tol,
                               rtol=0)
    assert int(got["overflow"]) == int(ref["overflow"]) == 0
