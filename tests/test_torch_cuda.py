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


EYE_W, EYE_H = 128, 96


def eye_scene(inside: bool, device):
    """EmeraldSquare's box town (7,322 triangles) and a view of it: with
    the eye among its buildings (about 1,600 triangles wholly behind the
    eye), or from the scene's own camera outside the town (none)."""
    from rtsdm_tpu_torch.scene.camera import Camera
    from rtsdm_tpu_torch.scene.procedural import emerald_square
    st = emerald_square(aspect=EYE_W / EYE_H, device=device)
    if inside:
        st = st.with_camera(Camera.create(
            position=(0.0, 1.7, 0.0), target=(10.0, 1.0, 4.0),
            focal_length=21.0, aspect=EYE_W / EYE_H, near_z=0.1,
            far_z=500.0, device=device))
    return st


def parent_bins(view_proj, positions, w: int, h: int, cull: str = "back"):
    """K1's inputs binned without the eye-plane cull, every valid triangle
    in screen-morton order: (chunks, tri_boxes, lists, counts, nby,
    nbx)."""
    coef, bbox, valid = R._setup_triangles(view_proj, positions, w, h, 0.0,
                                           0.0, R.CULL_MODES[cull])
    order = RC.screen_morton_order(bbox, valid, w, h)
    return R._pack_bins(coef[order], bbox[order], valid[order], order,
                        -(-h // RC.TILE_RH), -(-w // RC.TILE_RW))


def sd16_edge_depths(rng, shape):
    """float32 depths for the 16-bit SD pack: about a third whose product
    with 65535 is a half-integer in float32 (round half to even decides),
    a third below 0 or above 1 (clamped) and a third uniform in [0, 1]."""
    n = rng.integers(0, 65535, shape)
    tie = ((n + 0.5) / 65535).astype(np.float32)
    assert ((tie * np.float32(65535)) == (n + 0.5)).all()
    off = rng.choice(np.float32([-1.5, -1e-6, 0.0, 1.0, 1.000001, 2.0]),
                     shape)
    pick = rng.integers(0, 3, shape)
    return np.where(pick == 0, tie, np.where(
        pick == 1, off, rng.uniform(0.0, 1.0, shape))).astype(np.float32)


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
                                ADV_W, ADV_H, 0.0, 0.0, "none")[0]
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


def misaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_sd_fetch_kernel_packs_as_plain_on_gpu(cuda_device, k):
    """K4 packs the float SD map itself: against fetch_sd_packed_plain of
    pack_sd16 for odd and even k, with depths whose product with 65535 is a
    half-integer and depths outside [0, 1], at quarter sizes that are not
    multiples of its 32x8 tiles; k = 4 also from a map that is not 16-byte
    aligned (the kernel then reads it float by float)."""
    rng = np.random.default_rng(43 + k)
    h, w, dev, guard = 52, 140, cuda_device, 24
    levels, offs, radii = S.offset_tables(_Cfg(), 20.0)
    pad = int(-(-float(levels[-1]) // 4)) + 1
    radius = S.deinterleave(torch.as_tensor(
        rng.uniform(0.5, 30.0, (h, w)).astype(np.float32), device=dev))
    sd = torch.as_tensor(sd16_edge_depths(
        rng, (h // 4 + 2 * guard, w // 4 + 2 * guard, k)), device=dev)
    want = F.fetch_sd_packed_plain(F.pack_sd16(sd), guard, radius, levels,
                                   offs, radii)
    assert want.shape == (len(offs), 16, (k + 1) // 2, h // 4, w // 4)
    for m in ([sd, misaligned(sd)] if k == 4 else [sd]):
        got = F.fetch_sd_packed(m, guard, radius, levels, offs, radii, pad)
        assert got is not None and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("divisor", [1, 2])
def test_sd_strided_fetch_kernel_matches_plain_on_gpu(cuda_device, divisor,
                                                      k):
    """K11 against fetch_sd_strided_plain (fetch_sd_direction of
    shift_level_index's levels) at divisors 1 and 2, every direction, at
    quarter sizes that are not multiples of its 32x8 tiles, with radii
    whose fetches clamp at the map's edges and a NaN radius; k = 4 also
    from a map that is not 16-byte aligned. One launch a call."""
    from rtsdm_tpu_torch import _build
    rng = np.random.default_rng(71 + 2 * k + divisor)
    h, w, dev, guard = 52, 140, cuda_device, 24
    s = 4 // divisor
    levels, offs, radii = S.offset_tables(_Cfg(), 20.0)
    r = rng.uniform(0.5, 30.0, (h, w)).astype(np.float32)
    r[0, :3] = (np.nan, np.inf, 0.0)
    radius = S.deinterleave(torch.as_tensor(r, device=dev))
    sd = torch.as_tensor(rng.uniform(
        0.0, 1.0, (h // 4 * s + 2 * guard, w // 4 * s + 2 * guard, k))
        .astype(np.float32), device=dev)
    for m in ([sd, misaligned(sd)] if k == 4 else [sd]):
        for d in range(len(offs)):
            want = F.fetch_sd_strided_plain(sd, guard, radius, levels, offs,
                                            radii, d, divisor)
            _build.LAUNCHES.clear()
            got = F.fetch_sd_strided(m, guard, radius, levels, offs, radii,
                                     d, divisor)
            assert _build.LAUNCHES["rtsdm_fetch_sd_strided"] == 1
            assert want.shape == (16, k, h // 4, w // 4)
            assert torch.equal(got, want)


def _phase2_frame(dev, kernel, divisor, guard, k, rng, h=45, w=70, nd=8):
    """Phase 2's inputs at a size that is neither a multiple of 4 nor of a
    block: depths from near the eye (the radius clamps at ssMaxRadius, so
    most ring samples leave the screen) to far (below a pixel: level 0),
    a few at 0 and at infinity, normals in every direction (some in the
    view plane), a stencil with empty texels, a DualDepth layer behind."""
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.scene.camera import Camera
    cam = Camera.create(aspect=w / h, near_z=0.1, far_z=100.0, device=dev)
    cfg = A.VAOConfig(radius=0.6, thickness=0.25, ss_max_radius=40.0,
                      num_directions=nd, kernel=kernel, resolution=(w, h),
                      low_resolution=(-(-w // divisor), -(-h // divisor)),
                      sd_guard=guard)
    depth = rng.uniform(0.12, 30.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 90.0
    depth[0, :3] = (0.0, np.inf, 1e-3)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n[rng.random((h, w)) < 0.05, 2] = 0.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    stencil = rng.integers(0, 256, (h, w)).astype(np.int32)
    stencil[rng.random((h, w)) < 0.2] = 0
    sd_w, sd_h = cfg.low_resolution
    sd_map = rng.uniform(0.0, 1.0, (sd_h + 2 * guard, sd_w + 2 * guard, k))

    def t(a):
        return torch.as_tensor(a, device=dev)

    return (cam, cfg, t(depth), t(n), t(stencil),
            t(sd_map.astype(np.float32)), t(depth + 0.75))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("primary", ["SingleDepth", "DualDepth"])
@pytest.mark.parametrize("kernel", ["VAO", "HBAO"])
@pytest.mark.parametrize("divisor", [1, 2, 4])
def test_svao_resolve_kernel_matches_plain_loop_on_gpu(
        cuda_device, monkeypatch, divisor, kernel, primary, k):
    """K12 against svao_resolve_plain (phase 2's direction loop) at every
    call of svao_phase2_shift, on the same K3, K4 and K11 outputs: VAO and
    HBAO; divisors 1 and 2 (K11's float slots, one launch a direction, each
    adding to the last's delta) and 4 (K4's pairs, one launch for the
    ring); Single and DualDepth, the SD jitter on and off; k = 1, 3 (a
    pair's high half unused), 4 and 8. Every texel equal bit for bit, NaNs
    (the depth at infinity) at the same texels. (No texel samples its own
    pixel: a ring offset is at least a pixel long.)"""
    from rtsdm_tpu_torch import _build
    from rtsdm_tpu_torch.passes import svao_shift as PH
    from rtsdm_tpu_torch.utils.sampling import AO_KERNEL_HBAO, AO_KERNEL_VAO
    guard = 48 // divisor
    rng = np.random.default_rng(
        [97, divisor, guard, k, int(kernel == "VAO"),
         int(primary == "DualDepth")])
    cam, cfg, depth, normal_v, stencil, sd_map, depth2 = _phase2_frame(
        cuda_device, AO_KERNEL_VAO if kernel == "VAO" else AO_KERNEL_HBAO,
        divisor, guard, k, rng)
    held = []
    kernel_call = PH.svao_resolve

    def both(*args, **kwargs):
        got = kernel_call(*args, **kwargs)
        want = PH.svao_resolve_plain(*args, **kwargs)
        held.append((got, want))
        return got

    monkeypatch.setattr(PH, "svao_resolve", both)
    _build.LAUNCHES.clear()
    # the SD jitter on under SingleDepth, off (0.5) under DualDepth
    PH.svao_phase2_shift(cam, cfg, depth, normal_v, stencil, sd_map,
                         primary == "SingleDepth", divisor, depth2=depth2,
                         primary=primary)
    per_ring = divisor == 4
    assert len(held) == (1 if per_ring else cfg.num_directions)
    assert _build.LAUNCHES["rtsdm_svao_resolve"] == len(held)
    assert _build.LAUNCHES["rtsdm_fetch_sd_packed"] == int(per_ring)
    for got, want in held:
        assert got.shape == want.shape == (16, 12, 18)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got.view(torch.int32)[~nan],
                           want.view(torch.int32)[~nan])
    assert bool((held[-1][1] != 0).any())


@pytest.mark.cuda
def test_svao_resolve_kernel_splits_a_long_ring_on_gpu(cuda_device):
    """A ring of 20 directions at divisor 4 (a launch's arguments hold 16):
    one wrapper call, two launches, the second adding to the first's delta;
    equal bit for bit to the plain loop over the ring."""
    from rtsdm_tpu_torch import _build
    from rtsdm_tpu_torch.ops import resolve_cuda as RV
    from rtsdm_tpu_torch.passes import svao_shift as PH
    from rtsdm_tpu_torch.utils.sampling import AO_KERNEL_VAO
    rng = np.random.default_rng(98)
    cam, cfg, depth, normal_v, _, sd_map, _ = _phase2_frame(
        cuda_device, AO_KERNEL_VAO, 4, 12, 4, rng, nd=20)
    stencil = torch.as_tensor(rng.integers(0, 2**20, depth.shape)
                              .astype(np.int32), device=cuda_device)
    held = []

    def both(*args, **kwargs):
        _build.LAUNCHES.clear()
        got = RV.svao_resolve(*args, **kwargs)
        held.append((_build.LAUNCHES["rtsdm_svao_resolve"], got,
                     PH.svao_resolve_plain(*args, **kwargs)))
        return got

    PH.svao_resolve, saved = both, PH.svao_resolve
    try:
        PH.svao_phase2_shift(cam, cfg, depth, normal_v, stencil, sd_map)
    finally:
        PH.svao_resolve = saved
    [(launches, got, want)] = held
    assert launches == 2
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("nci,nflat", [(8, 4), (3, 0), (2, 1)])
def test_attribute_fetch_kernel_matches_plain_on_gpu(cuda_device, nci,
                                                     nflat):
    """K2 against its plain version for the G-buffer's 12 outputs and two
    narrower layouts, at a pixel count that is not a multiple of its
    256-pixel blocks, with background pixels, on an all-background image,
    and (the G-buffer's layout) from a table that is not 16-byte aligned
    (its rows then read float by float)."""
    rng = np.random.default_rng(47 + nci)
    dev, t, h, w = cuda_device, 300, 37, 29
    table = torch.as_tensor(rng.normal(size=(t, 3 * nci + nflat))
                            .astype(np.float32), device=dev)
    tri_id = torch.as_tensor(rng.integers(-1, t, (h, w)).astype(np.int32),
                             device=dev)
    bary = torch.as_tensor(rng.uniform(0.0, 0.6, (h, w, 2))
                           .astype(np.float32), device=dev)
    tables = [table, misaligned(table)] if nci == 8 else [table]
    for ids in (tri_id, torch.full_like(tri_id, -1)):
        want = RC.fetch_attributes_plain(ids, bary, table, nci, nflat)
        assert want.shape == (h, w, nci + nflat)
        for tab in tables:
            assert torch.equal(
                RC.fetch_attributes(ids, bary, tab, nci, nflat), want)
    assert bool((tri_id < 0).any()) and bool((tri_id >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("cull_back", [True, False])
def test_trace_kernel_matches_plain_on_gpu(cuda_device, cull_back):
    """K5 and K7 against their plain versions in every insertion mode, for
    k of 1, 2 and 4, uncapped and with MaxCount 2; K7 equal to K5 on the
    same rays (K5 without screen rows lists what K7 lists); and the
    kernel's key function on the INT_MIN hash."""
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
    za = (dirs * cam.camera_w).sum(-1) / (cam.far_z - cam.near_z)
    zb = (cam.near_z / (cam.far_z - cam.near_z)).expand(n)
    rays = torch.stack([dirs[:, 0], dirs[:, 1], dirs[:, 2], tmin, tmax, za,
                        zb]).contiguous()
    for mode in RT.MODES:
        for k in (1, 2, 4):
            for mc in (0, 2):
                a = (k, cull_back, mode, mc, 0.375)
                got = RT.sd_trace_blocks(tri, aabb, origin, rays, *a)
                want = RT.sd_trace_blocks_plain(tri, aabb, origin, rays, *a)
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


def _pinhole_grid_rays(cam, h, w, rng, t_lo, t_hi, dev):
    """Row-major pinhole rays through an h x w grid's texels with seeded
    intervals (every 97th ray dead), their rays [7, n] rows and signed
    texel coordinates."""
    n = h * w
    py, px = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    signed = torch.stack([px, py], -1).reshape(n, 2).float()
    origin, dirs = cam.compute_ray_pinhole(
        signed, (w, h), jitter=torch.full((n, 2), 0.5, device=dev))
    tmin = torch.as_tensor(rng.uniform(0.0, t_lo, n).astype(np.float32),
                           device=dev)
    tmax = tmin + torch.as_tensor(
        rng.uniform(0.5, t_hi, n).astype(np.float32), device=dev)
    tmax[::97] = tmin[::97]
    cosw = (dirs * cam.camera_w).sum(-1) / cam.camera_w.norm()
    rays = RT._ray_rows(dirs, tmin, tmax, cosw, cam.near_z, cam.far_z)
    return origin, rays, signed


@pytest.mark.cuda
@pytest.mark.parametrize("cull_back", [True, False])
def test_trace_kernels_tiles_overflow_and_caps_on_gpu(cuda_device,
                                                      cull_back):
    """The redesigned K5 and K7 against their plain versions where the
    design decides: 1,100 chunks (width LIST_CAP, more than one list
    window) with tiles that overflow their list and walk every chunk and
    tiles that do not; K5 with its screen rows; K7 on an SD grid whose
    sides are not whole tiles; MaxCount 8 and coverage with k = 5."""
    dev = cuda_device
    cam = arcade(device=dev).camera
    rng = np.random.default_rng(41)
    n_chunks = 1100
    t = n_chunks * RT.TC
    fwd = (cam.target - cam.pos_w) / (cam.target - cam.pos_w).norm()
    centre = cam.pos_w + 6.0 * fwd
    v0 = centre + torch.as_tensor(rng.normal(0, 3.0, (t, 3)).astype(
        np.float32), device=dev)
    e1, e2 = (torch.as_tensor(rng.normal(0, 0.4, (t, 3)).astype(np.float32),
                              device=dev) for _ in range(2))
    order = torch.argsort(v0[:, 0])              # chunks of near triangles
    v0, e1, e2 = v0[order], e1[order], e2[order]
    acc = torch.as_tensor((rng.uniform(size=t) < 0.5).astype(np.float32),
                          device=dev)
    mask = torch.as_tensor(rng.choice([0xFFFF, 0x0F0F, 0x3333], t).astype(
        np.float32), device=dev)
    flags = torch.stack([acc, torch.zeros_like(acc), mask])
    tri, aabb = RT.pack_shared_origin(v0.T.contiguous(), e1.T.contiguous(),
                                      e2.T.contiguous(), flags, cam.pos_w)
    h, w = 27, 70
    origin, rays, signed = _pinhole_grid_rays(cam, h, w, rng, 4.0, 6.0, dev)
    # short intervals in the left half: tiles there list few chunks
    rays[4] = torch.where(torch.arange(rays.shape[1], device=dev) % w < 32,
                          torch.minimum(rays[4], rays[3] + 0.3), rays[4])
    scr = RT.chunk_screen_rows(aabb, origin, cam.camera_u, cam.camera_v,
                               cam.camera_w, w, h)
    aabb12 = torch.cat([aabb[:6], scr]).contiguous()

    def tf(a, fill=0.0):                          # 8x32-tile order
        return RT.tile_flatten(RT.pad_tile(
            a[:h * w].reshape((h, w) + a.shape[1:]), fill)[0]).contiguous()

    tiled = torch.stack([tf(rays[i], -1.0 if i == 4 else 0.0)
                         for i in range(7)]).contiguous()
    rx, ry = tf(signed[:, 0]), tf(signed[:, 1])
    _, counts = RT.build_chunk_lists(aabb12, origin, tiled[0:3].T, tiled[3],
                                     tiled[4], rx, ry)
    assert (counts > RT.LIST_CAP).any() and (counts <= RT.LIST_CAP).any()
    for k, mode, mc in ((4, "default", 0), (4, "kbuffer", 0),
                        (4, "default", 8), (5, "coverage", 0)):
        a = (k, cull_back, mode, mc, 1.5 / k)
        got = RT.sd_trace_blocks(tri, aabb12, origin, tiled, *a, rx, ry)
        assert torch.equal(got, RT.sd_trace_blocks_plain(
            tri, aabb12, origin, tiled, *a, rx, ry)), (mode, k, mc)
        res = RT.sd_trace_resident_blocks(tri, aabb[:6].contiguous(),
                                          origin, rays, *a, grid=(h, w))
        assert torch.equal(res, RT.sd_trace_resident_blocks_plain(
            tri, aabb[:6].contiguous(), origin, rays, *a,
            grid=(h, w))), (mode, k, mc)
        # K7's tiles are K5's: without the screen rows K5 lists what K7
        # lists, but walks every chunk where a tile overflows its width;
        # no chunk either culls holds an accepted pair, so the slots agree
        k5 = RT.sd_trace_blocks(tri, aabb[:6].contiguous(), origin, tiled,
                                *a)
        k5 = RT.tile_unflatten(k5, h + (-h) % 8, w + (-w) % 32)[:h, :w]
        assert torch.equal(res, k5.reshape(h * w, k)), (mode, k, mc)
        assert bool((got != RT.INVALID).any())
        if mc:
            assert bool(((res != RT.INVALID).sum(1) <= mc).all())


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
                            h, 0.0, 0.0, "back")[0]


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
    """K9, with its per-triangle cull, against its plain version without
    it for k of 1, 4 and 8, with a first layer and a ray interval that
    exclude some fragments, with full and short lists, its walk whole and
    split over 3 parts."""
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
            want = RC.raster_stochastic_blocks_plain(chunks, None, ls, counts,
                                                     nby, nbx, *planes, k,
                                                     alpha)
            for parts in (1, 3):
                got = RC.raster_stochastic_blocks(chunks, boxes, ls, counts,
                                                  nby, nbx, *planes, k,
                                                  alpha, parts=parts)
                assert torch.equal(got, want), (k, lw, parts)
        hit = got < RC.SD_EMPTY
        assert bool(hit.any()) and not bool(hit.all())


@pytest.mark.cuda
def test_raster_stochastic_cull_is_exact_on_gpu(cuda_device):
    """K9's per-triangle cull on the adversarial scene (70x45: triangles
    through the eye plane, slivers on tile borders, near-degenerate ones):
    bit-exact with the plain version without the cull, padding pixels
    included, with full and short lists, whole and split into 4 parts."""
    vp, pos = adversarial_scene()
    args = R._binned_chunks(torch.as_tensor(vp, device=cuda_device),
                            torch.as_tensor(pos, device=cuda_device),
                            ADV_W, ADV_H, 0.0, 0.0, "none")[0]
    chunks, boxes, lists, counts, nby, nbx = args
    lin = adversarial_floor(RC.raster_blocks(*args)[0])
    rng = np.random.default_rng(41)
    first = torch.where(torch.as_tensor(rng.random(lin.shape) < 0.5,
                                        device=cuda_device), -3e38, lin)
    rmax = torch.full_like(lin, 3e38)
    planes = [a.contiguous() for a in (first, torch.zeros_like(lin), rmax)]
    for lw in (lists.shape[1], 2):
        ls = lists[:, :lw].contiguous()
        want = RC.raster_stochastic_blocks_plain(chunks, None, ls, counts,
                                                 nby, nbx, *planes, 4, 0.375)
        for parts in (1, 4):
            got = RC.raster_stochastic_blocks(chunks, boxes, ls, counts, nby,
                                              nbx, *planes, 4, 0.375,
                                              parts=parts)
            assert torch.equal(got, want), (lw, parts)
    assert bool((want < RC.SD_EMPTY).any())


@pytest.mark.cuda
@pytest.mark.parametrize("inside", [True, False])
def test_eye_cull_leaves_kernels_bit_equal_on_gpu(cuda_device, inside):
    """K1 (plain and with the first layer as a depth floor) and K9 on the
    eye-culled binning give bit for bit what they give on the binning
    without the cull (parent_bins), with the eye among EmeraldSquare's
    buildings and outside the town; the binning makes no host sync."""
    st = eye_scene(inside, cuda_device)
    vp, pos = st.camera.view_proj_no_jitter, st.positions
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bins, culled = R._binned_chunks(vp, pos, EYE_W, EYE_H, 0.0, 0.0,
                                        "back")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    base = parent_bins(vp, pos, EYE_W, EYE_H)
    assert (int(culled) > 0) == inside
    z = RC.raster_blocks(*base)[0]
    floor = dict(floor=st.camera.linearize_depth(z).contiguous(),
                 min_separation=0.5)
    for kw in ({}, floor):
        for a, b in zip(RC.raster_blocks(*bins, **kw),
                        RC.raster_blocks(*base, **kw)):
            assert torch.equal(a, b), kw.keys()
    lin = st.camera.linearize_depth(z)
    first = torch.where(torch.arange(lin.numel(), device=cuda_device)
                        .reshape(lin.shape) % 3 == 0, -3e38, lin)
    planes = [first.contiguous(), torch.zeros_like(lin),
              torch.full_like(lin, 3e38)]
    got = RC.raster_stochastic_blocks(*bins, *planes, 4, 0.375)
    assert torch.equal(got, RC.raster_stochastic_blocks(*base, *planes, 4,
                                                        0.375))
    assert bool((got < RC.SD_EMPTY).any())


@pytest.mark.cuda
@pytest.mark.parametrize("qh,qw", [(24, 40), (13, 70)])
def test_same_class_fetch_kernel_matches_plain_on_gpu(cuda_device, qh, qw):
    """K6 (HBAO's 8 directions x 4 steps) against its plain version for one
    and two plane sets, with level planes that include out-of-range
    levels, at quarter sizes that are not multiples of its 32x8 tiles."""
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.passes import hbao as H
    rng = np.random.default_rng(31)
    dev = cuda_device
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


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,x0,y0", [(2232, 3072, 0, 0), (215, 357, 1, 3)])
def test_jitter_grid_is_built_on_the_device(cuda_device, h, w, x0, y0):
    """The SD pass's ray jitter, built on the card from the 4x4 table by
    1-D gathers (config 3's 2232x3072 SD grid, and a ragged grid from an
    offset), equals the numpy tiling it replaced bit for bit, and allocates
    the grid alone: no index the size of the grid (indexing the table with
    broadcast row and column indices made two int64 grids on the card)."""
    from rtsdm_tpu_torch.utils.sampling import (JITTER_4X4, jitter_grid,
                                                jitter_table)
    jitter_table(cuda_device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = jitter_grid(h, w, True, x0, y0, device=cuda_device)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - got.nbytes
    assert got.is_cuda and extra < 2**20, extra
    tab = np.roll(JITTER_4X4.reshape(4, 4, 2), -x0, axis=1)
    want = np.tile(tab, (-(-h // 4) + 1, -(-w // 4), 1))[y0:y0 + h, :w]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_svao_frame_makes_no_host_to_device_copy_on_gpu(cuda_device):
    """scripts/SVAO_small.py on the card (CornellBox 96x96, the ray-traced SD
    map, both shift-mode phases), two frames under torch.profiler with the
    program's spans: the first builds SVAO's tables (tables.svao) and
    uploads them; the second makes no host-to-device copy inside
    renderFrame/SVAO and builds no table."""
    import sys
    sys.path.insert(0, str(ROOT))
    from chip_smoke import h2d_copies_by_span
    from torch.profiler import ProfilerActivity, profile

    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.passes import svao_shift as PH
    from rtsdm_tpu_torch.utils import device as D
    for cached in (D._constant, A._dir_params, PH._class_consts):
        cached.cache_clear()
    m = Renderer(96, 96, device=cuda_device)
    run_script(str(ROOT / "scripts" / "SVAO_small.py"), m)
    m.active_graph.get_pass("GuardBand").cfg["guardBand"] = 8
    m.loadScene("CornellBox")
    m.clock.pause()
    m.profiler.enabled = True
    found = []
    for f in range(2):
        m.clock.frame = f
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.renderFrame()
            torch.cuda.synchronize()
        events = prof.events()
        copies = h2d_copies_by_span(events)
        found.append((sum(n for span, n in copies.items()
                          if span.startswith("renderFrame/SVAO")),
                      sum(1 for e in events
                          if e.name.endswith("/tables.svao"))))
    (copies0, tables0), (copies1, tables1) = found
    assert copies0 > 0 and tables0 > 0
    assert copies1 == 0 and tables1 == 0
