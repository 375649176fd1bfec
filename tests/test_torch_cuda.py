"""The five CUDA kernels of rtsdm_tpu_torch against their plain PyTorch
versions on the card (marker `cuda`; they skip where there is no GPU).

This file imports neither jax nor rtsdm_tpu, so on a machine with a GPU
and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Every comparison is bit-exact: the kernels are built with --fmad=false and
without fast math, so each expression rounds as the plain version's
separate PyTorch operations do.
"""
import numpy as np
import pytest
import torch

from rtsdm_tpu_torch.ops import ao_shift as S
from rtsdm_tpu_torch.ops import fetch_cuda as F
from rtsdm_tpu_torch.ops import raster as R
from rtsdm_tpu_torch.ops import raster_cuda as RC
from rtsdm_tpu_torch.ops import rt_cuda as RT
from rtsdm_tpu_torch.scene.procedural import arcade

INT_MIN = -2**31


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_raster_kernels_match_plain_on_gpu(cuda_device):
    """K1 and K2 against their plain versions, same inputs, with a list
    width small enough that some tiles stream every chunk."""
    st = arcade(aspect=1.5, device=cuda_device)
    w, h = 96, 64
    coef, bbox, valid = R._setup_triangles(st.camera.view_proj_mat,
                                           st.positions, w, h, 0.0, 0.0,
                                           R.CULL_BACK)
    order = RC.screen_morton_order(bbox, valid, w, h)
    chunks = RC.pack_coef_chunks(coef[order], valid[order], order)
    lists, counts = RC.build_chunk_lists_2d(
        RC.chunk_screen_bboxes(bbox[order], valid[order]), 8, 3)
    for lw in (lists.shape[1], 2):
        ls = lists[:, :lw].contiguous()
        got = RC.raster_blocks(chunks, ls, counts, 8, 3)
        want = RC.raster_blocks_plain(chunks, ls, counts, 8, 3)
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
    """K5 against its plain version in both insertion modes and for k of
    1, 2 and 4; and the kernel's key function on the INT_MIN hash."""
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
            got = RT.sd_trace_blocks(tri, lists, counts, rays, k, cull_back,
                                     mode)
            want = RT.sd_trace_blocks_plain(tri, lists, counts, rays, k,
                                            cull_back, mode)
            assert torch.equal(got, want), (mode, k)
    assert ((got != RT.INVALID).sum(1) > 1).any()
    hb = torch.tensor([INT_MIN, INT_MIN + 1, -1, 0, 7, 2**31 - 1],
                      dtype=torch.int32)
    u = torch.as_tensor(rng.uniform(0, 1, 6).astype(np.float32))
    key_uv, key_hb = RT.sd_keys(u.to(dev), u.to(dev), hb.to(dev))
    want_uv, want_hb = RT.sd_keys(u, u, hb)
    assert key_hb.tolist() == want_hb.tolist()
    assert key_hb.tolist()[0] == 32765
    assert torch.equal(key_uv.cpu(), want_uv)
