"""Parity of rtsdm_tpu_torch's utilities, camera and scene building with the
rtsdm_tpu reference on the CPU.

Tolerances: integer and table outputs (morton order, triangle arrays,
encoded normals, jitter tables) are bit-exact. Float32 math is held to
atol 1e-6 (about one ulp at the magnitudes involved): XLA:CPU contracts
a*b+c into fused multiply-adds while PyTorch rounds every operation, so
results that pass through such expressions may differ in the last bit.
"""
import contextlib

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp

from rtsdm_tpu.ops import ao_shift as AOSJ
from rtsdm_tpu.scene import procedural as PJ
from rtsdm_tpu.utils import math as MJ
from rtsdm_tpu.utils import sampling as SJ
from rtsdm_tpu_torch.scene import procedural as PT
from rtsdm_tpu_torch.scene.camera import CAMERA_FIELDS, Camera
from rtsdm_tpu_torch.scene.scene import SCENE_FIELDS, scene_from_numpy
from rtsdm_tpu_torch.utils import math as MT
from rtsdm_tpu_torch.utils import sampling as ST

ATOL = 1e-6


def carry(scene_j, device="cpu"):
    """The reference scene's arrays and camera handed to the port (an
    absent optional field, e.g. no env map, arrives as None)."""
    def arr(f):
        a = getattr(scene_j, f)
        return None if a is None else np.asarray(a)

    return scene_from_numpy(
        {f: arr(f) for f in SCENE_FIELDS},
        {f: np.asarray(getattr(scene_j.camera, f)) for f in CAMERA_FIELDS},
        device=device, name=scene_j.name)


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("builder", ["cornell_box", "arcade", "bistro",
                                     "emerald_square"])
def test_scene_arrays_match_reference(builder):
    sj = getattr(PJ, builder)()
    st = getattr(PT, builder)(device="cpu")
    assert st.num_triangles == sj.num_triangles
    assert st.num_lights == sj.num_lights
    for f in SCENE_FIELDS:
        if f == "normals":
            continue
        a, b = getattr(st, f), getattr(sj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    np.testing.assert_allclose(st.normals.numpy(), np.asarray(sj.normals),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(st.face_normals().numpy(),
                               np.asarray(sj.face_normals()), atol=ATOL,
                               rtol=0)


def test_sun_temple_small_morton_order():
    """make_scene's morton sort (the shared scenekit source, compiled by
    the port's own loader) orders SunTemple@small exactly like rtsdm_tpu."""
    sj = PJ.sun_temple(detail="small")
    st = PT.load_scene("SunTemple", aspect=16 / 9, device="cpu")
    np.testing.assert_array_equal(st.positions.numpy(),
                                  np.asarray(sj.positions))
    np.testing.assert_array_equal(st.tri_alpha_mask.numpy(),
                                  np.asarray(sj.tri_alpha_mask))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(position=(1.0, 1.0, 4.4), target=(1.0, 1.0, 0.0), focal_length=35.0,
         near_z=0.1, far_z=100.0),
    dict(position=(-21.0, 3.7, 27.0), target=(0.0, 1.0, 0.0),
         aspect=16 / 9, near_z=0.1, far_z=500.0, jitter=(0.1, -0.2)),
])
def test_camera_create_matches_reference(kw):
    from rtsdm_tpu.scene.camera import Camera as CJ
    cj, ct = CJ.create(**kw), Camera.create(**kw, device="cpu")
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), atol=ATOL,
                                   rtol=1e-6, err_msg=f)


def test_camera_math_matches_reference():
    sj = PJ.cornell_box()
    cj, ct = sj.camera, carry(sj).camera
    rng = np.random.default_rng(1)
    uv = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    z = rng.uniform(0.2, 50, 64).astype(np.float32)
    nl = rng.uniform(0, 1, 64).astype(np.float32)
    px = rng.uniform(0, 64, (64, 2)).astype(np.float32)
    jit = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(ct.image_scale().numpy(),
                               np.asarray(cj.image_scale()), atol=ATOL)
    np.testing.assert_allclose(ct.uv_to_view_space(t(uv), t(z)).numpy(),
                               np.asarray(cj.uv_to_view_space(uv, z)),
                               rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(ct.linearize_depth(t(nl)).numpy(),
                               np.asarray(cj.linearize_depth(nl)), rtol=1e-6)
    for j in (None, jit):
        o_t, d_t = ct.compute_ray_pinhole(t(px), (64, 48),
                                          None if j is None else t(j))
        o_j, d_j = cj.compute_ray_pinhole(px, (64, 48), j)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=ATOL)


def test_scene_from_numpy_carries_fields_exactly():
    for sj in (PJ.arcade(), PJ.cornell_box()):
        st = carry(sj)
        for f in SCENE_FIELDS:
            a, b = getattr(st, f), getattr(sj, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(st.camera, f).numpy(),
                                      np.asarray(getattr(sj.camera, f)))


def test_normal_encoding_matches_reference():
    rng = np.random.default_rng(2)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    enc_j = np.asarray(MJ.encode_normal_2x16(jnp.asarray(n)))
    enc_t = MT.encode_normal_2x16(t(n)).numpy()
    assert enc_t.dtype == np.int32
    # the quantized codes may differ by one step where XLA's fused
    # multiply-add moves a value across a rounding boundary
    du = np.abs((enc_t.view(np.uint32) & 0xFFFF).astype(np.int64)
                - (enc_j & 0xFFFF).astype(np.int64))
    dv = np.abs((enc_t.view(np.uint32) >> 16).astype(np.int64)
                - (enc_j >> 16).astype(np.int64))
    assert max(du.max(), dv.max()) <= 1 and (enc_t.view(np.uint32)
                                             == enc_j).mean() > 0.99
    dec_j = np.asarray(MJ.decode_normal_2x16(jnp.asarray(enc_j)))
    dec_t = MT.decode_normal_2x16(t(enc_j.view(np.int32))).numpy()
    np.testing.assert_allclose(dec_t, dec_j, atol=ATOL)


@contextlib.contextmanager
def cuda_scalar_division():
    """While it holds, a tensor divided by a Python number is multiplied by
    the number's float32 reciprocal, as PyTorch does for a CUDA tensor
    (ROADMAP hazard c); a division by a tensor stays an IEEE division."""
    real = torch.Tensor.__truediv__

    def div(self, other):
        if isinstance(other, (int, float)):
            return self * torch.tensor(np.float32(1.0) / np.float32(other))
        return real(self, other)

    torch.Tensor.__truediv__ = div
    try:
        yield
    finally:
        torch.Tensor.__truediv__ = real


def test_normal_decode_is_an_ieee_division_on_every_device():
    """decode_normal_2x16 turns each 16-bit code into code / 65535 rounded
    once, as the reference package does, also where a division by a
    Python number becomes a multiply by its reciprocal (a CUDA tensor):
    there the card's SVAO read other view normals than the reference on
    0.2% of Arcade's pixels (H100 80GB HBM3)."""
    codes = np.arange(65536, dtype=np.int64)
    packed = torch.as_tensor((codes | (codes[::-1] << 16)).astype(np.uint32)
                             .view(np.int32))
    with cuda_scalar_division():
        got = MT.decode_normal_2x16(packed).numpy()
        recip = (packed & 0xFFFF).to(torch.float32) / 65535.0
    # on the CPU a division by a Python number is an IEEE division
    np.testing.assert_array_equal(got, MT.decode_normal_2x16(packed).numpy())
    ieee = codes.astype(np.float32) / np.float32(65535.0)
    assert (recip.numpy() != ieee).any()
    want = np.asarray(MJ.decode_normal_2x16(jnp.asarray(packed.numpy())))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_transforms_and_hashes_match_reference():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(33, 3)).astype(np.float32)
    np.testing.assert_allclose(MT.transform_point(t(m), t(p)).numpy(),
                               np.asarray(MJ.transform_point(m, p)),
                               atol=ATOL * 10)
    np.testing.assert_allclose(MT.transform_vector(t(m), t(p)).numpy(),
                               np.asarray(MJ.transform_vector(m, p)),
                               atol=ATOL * 10)
    v = rng.uniform(0, 4, (257, 3)).astype(np.float32)
    # hash2 scales sin() by 1e4 before the mod: a one-ulp difference of sin
    # moves the fraction by ~1e-3, so only the range and most values agree
    h_t = MT.hash3(t(v)).numpy()
    h_j = np.asarray(MJ.hash3(jnp.asarray(v)))
    assert ((h_t >= 0) & (h_t < 1)).all()
    assert (np.abs(h_t - h_j) < 1e-2).mean() > 0.9


def test_sampling_tables_match_reference():
    for kernel in (SJ.AO_KERNEL_VAO, SJ.AO_KERNEL_HBAO):
        np.testing.assert_array_equal(ST.sample_radius_table(8, kernel),
                                      SJ.sample_radius_table(8, kernel))
    np.testing.assert_array_equal(ST.DITHER_4X4, SJ.DITHER_4X4)
    np.testing.assert_array_equal(ST.JITTER_4X4, SJ.JITTER_4X4)
    px = np.arange(40, dtype=np.int32) * 7
    py = np.arange(40, dtype=np.int32) * 3
    np.testing.assert_array_equal(
        ST.random_jitter(t(px), t(py)).numpy(),
        np.asarray(SJ.random_jitter(jnp.asarray(px), jnp.asarray(py))))


@pytest.mark.parametrize("h,w,enabled,x0,y0,ref", [
    (18, 37, True, 0, 0, "jitter_grid"),
    (18, 37, True, 3, 2, "jitter_grid"),
    (18, 37, False, 0, 0, "jitter_grid"),
    (215, 357, True, 1, 3, "jitter_grid"),
    (2232, 3072, True, 0, 0, "jitter_grid"),    # config 3's SD grid
    (302, 512, True, 0, 0, "tiled_jitter"),     # config 3's phase 2
    (302, 512, False, 0, 0, "tiled_jitter")])
def test_jitter_grid_matches_reference(h, w, enabled, x0, y0, ref):
    """The SD pass's ray jitter and phase 2's, both built on the device
    from the 4x4 table (utils/sampling.jitter_grid), equal the reference's
    tiled tables bit for bit: jitter_grid from (x0, y0), and
    ao_shift.tiled_jitter, which tiles from (0, 0)."""
    got = ST.jitter_grid(h, w, enabled, x0, y0, device="cpu")
    if ref == "jitter_grid":
        want = SJ.jitter_grid(h, w, enabled, x0, y0)
    else:
        want = AOSJ.tiled_jitter(h, w, enabled)
    assert got.dtype == torch.float32 and got.shape == (h, w, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,aspect", [("CornellBox", 1.0),
                                         ("Arcade", 16 / 9)])
def test_load_scene_matches_reference(name, aspect):
    """load_scene builds the reference's arrays: geometry, materials, the
    texture pages, the env map and the lights."""
    sj = PJ.load_scene(name, aspect=aspect)
    st = PT.load_scene(name, aspect=aspect, device="cpu")
    for f in SCENE_FIELDS:
        a, b = getattr(st, f), getattr(sj, f)
        assert (a is None) == (b is None), f
        if a is not None and f != "normals":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(st.camera, f).numpy(),
                                   np.asarray(getattr(sj.camera, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    assert (st.tex_pages is not None) == (name == "Arcade")
