"""The CUDA kernels of rtsdm_tpu_torch against their plain PyTorch
versions on the card, and the SVAO_small graph on the card (marker `cuda`;
they skip where there is no GPU).

This file imports neither jax nor rtsdm_tpu, so on a machine with a GPU
and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Every comparison is bit-exact: the kernels are built with --fmad=false and
without fast math, so each expression rounds as the plain version's
separate PyTorch operations do.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

from rtsdm_tpu_torch.ops import ao_shift as S
from rtsdm_tpu_torch.ops import fetch_cuda as F
from rtsdm_tpu_torch.ops import raster as R
from rtsdm_tpu_torch.ops import raster_cuda as RC
from rtsdm_tpu_torch.ops import rt_cuda as RT
from rtsdm_tpu_torch.ops import warp_cuda as W
from rtsdm_tpu_torch.scene.procedural import arcade

ROOT = Path(__file__).resolve().parents[1]

INT_MIN = -2**31


# the adversarial scene of the K1 cull tests (tests/test_torch_raster.py
# too): its own projection maps a world point (X, Y, Z) to clip (X, Y,
# A Z + B, -Z), view depth d = -Z, near 0.1, far 100
ADV_W, ADV_H = 70, 45          # neither a multiple of the 32x8 tile
ADV_NEAR, ADV_FAR = 0.1, 100.0
ADV_A = ADV_FAR / (ADV_NEAR - ADV_FAR)
ADV_B = ADV_NEAR * ADV_FAR / (ADV_NEAR - ADV_FAR)


def adversarial_scene(w=ADV_W, h=ADV_H, seed=23):
    """(view_proj [4,4], positions [T,3,3]) float32 numpy: triangles
    crossing the near plane, vertices just in front of and on the eye
    plane, triangles far larger than the screen, slivers along tile
    borders and through pixel centres, triangles reaching into the padding
    of the partial tiles, degenerate ones, and random small and mid-size
    ones clustered on tile borders."""
    vp = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, ADV_A, ADV_B],
                   [0, 0, -1, 0]], np.float32)
    rng = np.random.default_rng(seed)

    def at(sx, sy, d):   # the world point at screen (sx, sy), view depth d
        return [(2 * sx / w - 1) * d, (1 - 2 * sy / h) * d, -d]

    tris = [[at(10, 10, 5), at(60, 30, 5), [0.3, 0.2, 1.0]],
            [at(40, 5, 3), [-0.5, -0.1, 0.5], at(5, 40, 8)],
            [at(12, 3, 6), at(50, 41, 6), [0.2, 0.1, 0.0]],
            [at(-4000, -3000, 40), at(5000, -200, 60), at(20, 6000, 50)],
            [at(-900, 700, 30), at(800, 900, 30), at(0, -2000, 30)],
            [at(60, 40, 5), at(95, 42, 5), at(65, 60, 5)],
            [at(10, 10, 5), at(20, 20, 5), at(30, 30, 5)]]
    for d0 in (1e-3, 1e-5, 1e-7):
        tris += [[at(30, 20, d0), at(50, 10, 6), at(20, 40, 7)],
                 [at(-300, 900, d0), at(66, 44, 9), at(69, 2, 9)]]
    for xb in (31.5, 32.0, 32.5, 63.5, 64.0, 69.5, 70.0):
        for eps in (0.0, 1e-6, 1e-3, 0.3):
            d = float(rng.uniform(2, 80))
            tris += [[at(xb, 0.5, d), at(xb + eps, 44.5, d),
                      at(xb - 0.01, 20, d + 1)],
                     [at(xb, 3.5, d), at(xb, 12.5, d), at(xb + eps, 8, d)]]
    for yb in (7.5, 8.0, 8.5, 15.5, 40.5, 44.5, 45.0):
        for eps in (0.0, 1e-6, 1e-3, 0.3):
            d = float(rng.uniform(2, 80))
            tris += [[at(0.5, yb, d), at(69.5, yb + eps, d),
                      at(35, yb + 0.01, d + 1)],
                     [at(31.5, yb, d), at(32.5, yb, d), at(32, yb - eps, d)]]
    for _ in range(300):
        cx = rng.choice([32.0, 64.0, 70.0]) + rng.normal(0, 1.5)
        cy = rng.choice([8.0, 16.0, 24.0, 40.0, 45.0]) + rng.normal(0, 1.5)
        r = rng.uniform(0.05, 4.0)
        d = rng.uniform(1.0, 90.0, 3)
        ang = rng.uniform(0, 2 * np.pi, 3)
        tris.append([at(cx + r * np.cos(t), cy + r * np.sin(t), dd)
                     for t, dd in zip(ang, d)])
    for _ in range(100):
        c = rng.uniform([-10, -10], [80, 55])
        v = c + rng.uniform(-20, 20, (3, 2))
        d = rng.uniform(1.0, 90.0, 3)
        tris.append([at(x, y, dd) for (x, y), dd in zip(v, d)])
    return vp, np.asarray(tris, np.float32)


def adversarial_floor(z):
    """The view depth of a raster's NDC depth z (the floor of depth
    peeling in the adversarial scene's projection)."""
    return (ADV_B / (z + ADV_A)).contiguous()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_raster_kernels_match_plain_on_gpu(cuda_device):
    """K1 (with its per-triangle cull) against its plain version without
    the cull, and K2 against its plain version, same inputs, with a list
    width small enough that some tiles stream every chunk."""
    st = arcade(aspect=1.5, device=cuda_device)
    w, h = 96, 64
    chunks, boxes, lists, counts, nby, nbx = _raster_inputs(st, w, h)
    for lw in (lists.shape[1], 2):
        ls = lists[:, :lw].contiguous()
        got = RC.raster_blocks(chunks, boxes, ls, counts, nby, nbx)
        want = RC.raster_blocks_plain(chunks, None, ls, counts, nby, nbx)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool((got[1] >= 0).any())
    table, nci, nflat = RC.pack_attr_rows(
        [st.positions, st.normals, st.texcoords],
        [st.face_normals(), st.material_id])
    bary = torch.stack(got[2:], -1).contiguous()
    assert torch.equal(
        RC.fetch_attributes(got[1], bary, table, nci, nflat),
        RC.fetch_attributes_plain(got[1], bary, table, nci, nflat))


@pytest.mark.cuda
@pytest.mark.parametrize("floored", [False, True])
@pytest.mark.parametrize("case", ["adversarial", "arcade_100x60"])
def test_raster_cull_is_exact_on_gpu(cuda_device, case, floored):
    """K1's per-triangle cull on the adversarial scene (70x45) and on
    Arcade at 100x60 (widths that are not multiples of 32): bit-exact with
    the plain version without the cull, padding pixels included, with full
    and short lists, plain and with the first layer as a depth floor."""
    if case == "adversarial":
        vp, pos = adversarial_scene()
        args = R._binned_chunks(torch.as_tensor(vp, device=cuda_device),
                                torch.as_tensor(pos, device=cuda_device),
                                ADV_W, ADV_H, 0.0, 0.0, "none")
        to_floor = adversarial_floor
    else:
        st = arcade(aspect=100 / 60, device=cuda_device)
        args = _raster_inputs(st, 100, 60)

        def to_floor(z):
            return st.camera.linearize_depth(z).contiguous()
    chunks, boxes, lists, counts, nby, nbx = args
    kw = {}
    if floored:
        z = RC.raster_blocks(*args)[0]
        kw = dict(floor=to_floor(z), min_separation=0.5)
    for lw in (lists.shape[1], 2):
        ls = lists[:, :lw].contiguous()
        got = RC.raster_blocks(chunks, boxes, ls, counts, nby, nbx, **kw)
        want = RC.raster_blocks_plain(chunks, None, ls, counts, nby, nbx,
                                      **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (case, floored, lw)
    assert bool((got[1] >= 0).any())


class _Cfg:
    num_directions = 4

    def radii(self):
        return np.asarray([0.8, 0.6, 0.4, 0.2], np.float32)


@pytest.mark.cuda
def test_fetch_kernels_match_plain_on_gpu(cuda_device):
    """K3 (one and two plane sets) and K4 against their plain versions."""
    rng = np.random.default_rng(3)
    h, w, dev = 64, 128, cuda_device
    levels, offs, radii = S.offset_tables(_Cfg(), 20.0)
    pad = int(-(-float(levels[-1]) // 4)) + 1
    depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    radius = S.deinterleave(torch.as_tensor(
        rng.uniform(0.5, 30.0, (h, w)).astype(np.float32), device=dev))
    sets = [S.pad_planes(S.deinterleave(torch.as_tensor(x, device=dev)), pad)
            for x in (depth, depth + 0.5)]
    for n_src in (1, 2):
        got = F.fetch_all_directions(sets[:n_src], pad, radius, levels, offs,
                                     radii)
        want = F.fetch_all_directions_plain(torch.stack(sets[:n_src]), pad,
                                            radius, levels, offs, radii)
        assert len(got) == n_src
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt)
    guard = 24
    sd = torch.as_tensor(rng.uniform(
        0.0, 1.0, (h // 4 + 2 * guard, w // 4 + 2 * guard, 4))
        .astype(np.float32), device=dev)
    got = F.fetch_sd_packed(sd, guard, radius, levels, offs, radii, pad)
    want = F.fetch_sd_packed_plain(F.pack_sd16(sd), guard, radius, levels,
                                   offs, radii)
    assert got is not None and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cull_back", [True, False])
def test_trace_kernel_matches_plain_on_gpu(cuda_device, cull_back):
    """K5 and K7 against their plain versions in every insertion mode, for
    k of 1, 2 and 4, uncapped and with MaxCount 2; K7 equal to K5 on the
    same rays (K5 given the world-box lists that K7 builds in-kernel); and
    the kernel's key function on the INT_MIN hash."""
    st = arcade(device=cuda_device)
    cam, dev = st.camera, cuda_device
    rng = np.random.default_rng(19)
    n = 4096
    px = torch.as_tensor(rng.uniform(0, 256, (n, 2)).astype(np.float32),
                         device=dev)
    origin, dirs = cam.compute_ray_pinhole(
        px, (256, 256), jitter=torch.full((n, 2), 0.5, device=dev))
    tmin = torch.as_tensor(rng.uniform(0.0, 2.0, n).astype(np.float32),
                           device=dev)
    tmax = tmin + torch.as_tensor(
        rng.uniform(0.5, 30.0, n).astype(np.float32), device=dev)
    tri, aabb = RT.prep_triangles_packed(st, True)
    lists, counts = RT.build_chunk_lists(aabb, origin, dirs, tmin, tmax)
    za = (dirs * cam.camera_w).sum(-1) / (cam.far_z - cam.near_z)
    zb = (cam.near_z / (cam.far_z - cam.near_z)).expand(n)
    rays = torch.stack([dirs[:, 0], dirs[:, 1], dirs[:, 2], tmin, tmax, za,
                        zb]).contiguous()
    for mode in RT.MODES:
        for k in (1, 2, 4):
            for mc in (0, 2):
                a = (k, cull_back, mode, mc, 0.375)
                got = RT.sd_trace_blocks(tri, lists, counts, rays, *a)
                want = RT.sd_trace_blocks_plain(tri, lists, counts, rays, *a)
                assert torch.equal(got, want), (mode, k, mc)
                res = RT.sd_trace_resident_blocks(tri, aabb[:6].contiguous(),
                                                  origin, rays, *a)
                assert torch.equal(res, RT.sd_trace_resident_blocks_plain(
                    tri, aabb[:6].contiguous(), origin, rays, *a)), (mode, k)
                assert torch.equal(res, got), (mode, k, mc)
    assert ((got != RT.INVALID).sum(1) > 1).any()
    hb = torch.tensor([INT_MIN, INT_MIN + 1, -1, 0, 7, 2**31 - 1],
                      dtype=torch.int32)
    u = torch.as_tensor(rng.uniform(0, 1, 6).astype(np.float32))
    key_uv, key_hb = RT.sd_keys(u.to(dev), u.to(dev), hb.to(dev))
    want_uv, want_hb = RT.sd_keys(u, u, hb)
    assert key_hb.tolist() == want_hb.tolist()
    assert key_hb.tolist()[0] == 32765
    assert torch.equal(key_uv.cpu(), want_uv)


@pytest.mark.cuda
@pytest.mark.parametrize("wrap_x", [False, True])
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "catmull_rom"])
def test_warp_kernel_matches_plain_on_gpu(cuda_device, mode, wrap_x):
    """K10 against its plain version on a smooth motion field, far
    out-of-bounds positions and scattered positions (the env-map shape:
    a small map sampled from a larger screen grid)."""
    rng = np.random.default_rng(5)
    dev = cuda_device
    for (h, w), (ho, wo) in (((70, 150), (70, 150)), ((16, 32), (40, 96))):
        tex = torch.as_tensor(rng.random((3, h, w)).astype(np.float32),
                              device=dev)
        ys, xs = np.meshgrid(np.arange(ho) + 0.5, np.arange(wo) + 0.5,
                             indexing="ij")
        fields = [(xs + 6 * np.sin(ys / 7), ys + 6 * np.cos(xs / 9)),
                  (xs + 500.0, ys - 300.0),
                  tuple(rng.uniform(-20, 200, (2, ho, wo)))]
        for fx, fy in fields:
            sx = torch.as_tensor(np.asarray(fx, np.float32), device=dev)
            sy = torch.as_tensor(np.asarray(fy, np.float32), device=dev)
            got = W.warp_resample(tex, sx, sy, mode, wrap_x)
            want = W.warp_resample_plain(tex, sx, sy, mode, wrap_x)
            assert got.shape == (3, ho, wo)
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "catmull_rom"])
def test_warp_kernel_channels_and_ragged_rows_on_gpu(cuda_device, mode, c):
    """K10 with 1 and 3 channels (its unrolled instances) and 4 (its
    generic loop), clamped and wrapped in x, at row widths that leave a
    ragged block (70, 150, 1001, 7) or none (64), and targets of fewer
    than 8 rows (256x1 blocks), against its plain version."""
    rng = np.random.default_rng(41 + c)
    dev = cuda_device
    tex = torch.as_tensor(rng.random((c, 33, 70)).astype(np.float32),
                          device=dev)
    for ho, wo in ((33, 70), (16, 64), (5, 150), (1, 1001), (9, 7)):
        ys, xs = np.meshgrid(np.arange(ho) + 0.5, np.arange(wo) + 0.5,
                             indexing="ij")
        for fx, fy in ((xs * 70 / wo + 3 * np.sin(ys / 5), ys * 33 / ho),
                       tuple(rng.uniform(-40, 120, (2, ho, wo)))):
            sx = torch.as_tensor(np.asarray(fx, np.float32), device=dev)
            sy = torch.as_tensor(np.asarray(fy, np.float32), device=dev)
            for wrap_x in (False, True):
                got = W.warp_resample(tex, sx, sy, mode, wrap_x)
                want = W.warp_resample_plain(tex, sx, sy, mode, wrap_x)
                assert got.shape == (c, ho, wo)
                assert torch.equal(got, want), (mode, c, ho, wo, wrap_x)


@pytest.mark.cuda
def test_any_hit_kernel_matches_plain_on_gpu(cuda_device):
    """K8 against its plain version: per-ray origins, random alpha masks on
    every triangle, dead rays, and a list width small enough that some
    tiles stream every chunk; random directions (the per-pair path, boxes
    of the whole sphere of directions) and one shared direction (hoisted,
    tight boxes). Hits must agree with the walk without the cull, pairs
    with the replay of the cull."""
    st = arcade(device=cuda_device)
    rng = np.random.default_rng(17)
    t, m = st.num_triangles, st.mat_alpha_mode.shape[0]
    st = dataclasses.replace(
        st, mat_alpha_mode=torch.ones(m, dtype=torch.int32,
                                      device=cuda_device),
        tri_alpha_mask=torch.as_tensor(
            rng.integers(0, 1 << 16, t).astype(np.int32),
            device=cuda_device))
    n = 8192
    pts = st.positions.reshape(-1, 3).cpu().numpy()
    origins = rng.uniform(pts.min(0), pts.max(0), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.5, 60.0, n).astype(np.float32)
    tmax[rng.random(n) < 0.2] = -1.0
    args = [torch.as_tensor(a, device=cuda_device) for a in
            (origins, d, np.full(n, 1e-3, np.float32), tmax)]
    sun = torch.tensor([-0.36, 0.89, 0.27], device=cuda_device)
    for dirs in (args[1], (sun / sun.norm()).expand(n, 3).contiguous()):
        tri, boxes, lists, counts, rays = RT.any_hit_inputs(
            st, args[0], dirs, *args[2:])
        for lw in (lists.shape[1], 2):
            ls = lists[:, :lw].contiguous()
            hit, pairs = RT.any_hit_blocks(tri, boxes, ls, counts, rays)
            hit_p, _ = RT.any_hit_blocks_plain(tri, None, ls, counts, rays)
            _, pairs_p = RT.any_hit_blocks_plain(tri, boxes, ls, counts,
                                                 rays)
            assert torch.equal(hit, hit_p)
            assert torch.equal(pairs, pairs_p)
        assert hit.any() and not hit.all()


def _raster_inputs(st, w, h):
    """K1/K9 inputs of a view: chunks, triangle boxes, lists, counts, tile
    grid."""
    return R._binned_chunks(st.camera.view_proj_no_jitter, st.positions, w,
                            h, 0.0, 0.0, "back")


@pytest.mark.cuda
def test_raster_floor_kernel_matches_plain_on_gpu(cuda_device):
    """K1 with its depth floor (depth peeling) against its plain version:
    the first layer's linear depth as the floor, min_separation 0.5, with
    full and short lists."""
    st = arcade(aspect=1.5, device=cuda_device)
    w, h = 96, 64
    chunks, boxes, lists, counts, nby, nbx = _raster_inputs(st, w, h)
    z = RC.raster_blocks(chunks, boxes, lists, counts, nby, nbx)[0]
    floor = st.camera.linearize_depth(z).contiguous()
    for lw in (lists.shape[1], 2):
        ls = lists[:, :lw].contiguous()
        got = RC.raster_blocks(chunks, boxes, ls, counts, nby, nbx,
                               floor=floor, min_separation=0.5)
        want = RC.raster_blocks_plain(chunks, None, ls, counts, nby, nbx,
                                      floor=floor, min_separation=0.5)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # the floor peeled the first layer and left a second one
    first_id = RC.raster_blocks(chunks, boxes, lists, counts, nby, nbx)[1]
    assert bool((got[1] >= 0).any())
    assert float((got[1] != first_id).float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.375, 1.0])
def test_raster_stochastic_kernel_matches_plain_on_gpu(cuda_device, alpha):
    """K9 against its plain version for k of 1, 4 and 8, with a first layer
    and a ray interval that exclude some fragments, and with full and
    short lists."""
    st = arcade(aspect=1.5, device=cuda_device)
    w, h = 96, 64
    chunks, boxes, lists, counts, nby, nbx = _raster_inputs(st, w, h)
    z = RC.raster_blocks(chunks, boxes, lists, counts, nby, nbx)[0]
    lin = st.camera.linearize_depth(z)
    rng = np.random.default_rng(29)
    first = torch.where(torch.as_tensor(rng.random(lin.shape) < 0.3,
                                        device=cuda_device), -3e38, lin)
    rmin = lin * torch.as_tensor(rng.uniform(0.5, 1.0, lin.shape)
                                 .astype(np.float32), device=cuda_device)
    rmin[::3] = 0.0
    rmax = lin + torch.as_tensor(rng.uniform(0.5, 20.0, lin.shape)
                                 .astype(np.float32), device=cuda_device)
    rmax[:, ::7] = 0.0
    planes = [a.contiguous() for a in (first, rmin, rmax)]
    for k in (1, 4, 8):
        for lw in (lists.shape[1], 2):
            ls = lists[:, :lw].contiguous()
            got = RC.raster_stochastic_blocks(chunks, ls, counts, nby, nbx,
                                              *planes, k, alpha)
            want = RC.raster_stochastic_blocks_plain(chunks, ls, counts, nby,
                                                     nbx, *planes, k, alpha)
            assert torch.equal(got, want), (k, lw)
        hit = got < RC.SD_EMPTY
        assert bool(hit.any()) and not bool(hit.all())


@pytest.mark.cuda
def test_same_class_fetch_kernel_matches_plain_on_gpu(cuda_device):
    """K6 (HBAO's 8 directions x 4 steps) against its plain version for one
    and two plane sets, with level planes that include out-of-range
    levels."""
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.passes import hbao as H
    rng = np.random.default_rng(31)
    qh, qw, dev = 24, 40, cuda_device
    levels = A.shift_radius_levels(float(H.MAX_SHIFT_REACH))
    pad = int(np.ceil(levels[-1]))
    offs = H.shift_offsets(levels, H.direction_tables())
    planes = S.pad_planes(torch.as_tensor(
        rng.uniform(1.0, 30.0, (2, 16, qh, qw)).astype(np.float32),
        device=dev), pad)
    lvl = torch.as_tensor(rng.integers(-1, len(levels) + 1,
                                       (H.NUM_STEPS, 16, qh, qw))
                          .astype(np.int32), device=dev)
    for n_src in (1, 2):
        got = F.fetch_taps_same_class(planes[:n_src], lvl, pad, offs)
        want = F.fetch_taps_same_class_plain(planes[:n_src], lvl, pad, offs)
        assert got.shape == (n_src, 32, 16, qh, qw)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_svao_small_graph_on_gpu(cuda_device):
    """scripts/SVAO_small.py through the port's harness on the card
    (CornellBox 96x96, guard band 8): K7, K8 and K10 launch every frame
    and the outputs are finite, cropped, with AO in [0, 1]."""
    from rtsdm_tpu_torch import _build
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = Renderer(96, 96, device=cuda_device)
    run_script(str(ROOT / "scripts" / "SVAO_small.py"), m)
    m.active_graph.get_pass("GuardBand").cfg["guardBand"] = 8
    m.loadScene("CornellBox")
    m.clock.pause()
    for f in range(2):
        m.clock.frame = f
        _build.LAUNCHES.clear()
        out = m.renderFrame()
        # TAA x2; CornellBox has no env map and no texture pages, so the
        # bilinear mode does not run
        assert _build.LAUNCHES[W.launch_key("catmull_rom")] == 2
        assert _build.LAUNCHES[W.launch_key("bilinear")] == 0
        assert _build.LAUNCHES["rtsdm_any_hit"] == 1
        # 36 triangles: the SD trace stays resident (K7), never streams
        assert _build.LAUNCHES["rtsdm_sd_trace_resident"] == 1
        assert _build.LAUNCHES["rtsdm_sd_trace"] == 0
    for v in out.values():
        assert v.shape[:2] == (96, 96) and bool(torch.isfinite(v).all())
    ao = out["AmbientOcclusion.out"][..., 0]
    assert float(ao.min()) >= 0.0 and float(ao.max()) <= 1.0
