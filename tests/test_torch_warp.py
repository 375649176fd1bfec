"""The plain version of the texture resample kernel (K10,
rtsdm_tpu_torch/ops/warp_cuda.py) and the port's texture samplers against
rtsdm_tpu on the CPU.

* Against the reference's XLA samplers (passes/temporal.py:_bilinear and
  _catmull_rom, scene/textures.py:sample_env and sample_pages): the same
  operations in the same order, so the values agree to a few float32 ulps
  (XLA:CPU contracts some a*b+c into fused multiply-adds; PyTorch rounds
  every operation). Bound: 1e-5 absolute on textures in [0, 1] (the env
  map's sun reaches 12, so that one is 1e-5 relative). sample_pages takes
  the reference's atlas form, so it is held to that form at 1e-5 and to
  the gather at 2e-5 (its test says why).
* Against warp_resample_pallas in interpret mode, on fields where its
  fallback plane never fires: 1e-4, the bound of the reference's own test
  (tests/test_pallas_interpret.py:565-568), since its separable 4x4
  Catmull-Rom form differs from the nine-tap form in rounding.
"""
import sys
from pathlib import Path
from unittest import mock

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

import rtsdm_tpu.ops.warp_pallas as WP  # noqa: E402
from rtsdm_tpu.passes import temporal as TJ  # noqa: E402
from rtsdm_tpu.scene import textures as XJ  # noqa: E402
from rtsdm_tpu_torch.ops import warp_cuda as W  # noqa: E402
from rtsdm_tpu_torch.passes import temporal as TT  # noqa: E402
from rtsdm_tpu_torch.scene import textures as XT  # noqa: E402

H, W_ = 40, 288   # wider than the TPU kernel's whole-map limit (256)


def _motion_field(h, w, amp=6.0):
    """Smooth +-amp px motion (the reference test's field) in uv units."""
    mv = np.stack([np.sin(np.linspace(0, 3, w))[None, :].repeat(h, 0),
                   np.cos(np.linspace(0, 2, h))[:, None].repeat(w, 1)], -1)
    return (mv * amp / np.asarray([w, h])).astype(np.float32)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(5)
    tex = rng.random((H, W_, 3)).astype(np.float32)
    uv = np.asarray(TJ._grid_uv(H, W_)) + _motion_field(H, W_)
    sp = (uv * np.asarray([W_, H], np.float32)).astype(np.float32)
    return tex, uv.astype(np.float32), sp


def _planar(tex):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(tex, -1, 0)))


@pytest.mark.parametrize("shift", [(0.0, 0.0), (500.0, -300.0)])
def test_catmull_rom_matches_xla_sampler(field, shift):
    tex, _, sp = field
    sp = (sp + np.asarray(shift, np.float32)).astype(np.float32)
    got = W.warp_resample_plain(_planar(tex), torch.as_tensor(sp[..., 0]),
                                torch.as_tensor(sp[..., 1]), "catmull_rom")
    want = np.asarray(TJ._catmull_rom(jnp.asarray(tex), jnp.asarray(sp)))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want,
                               atol=1e-5, rtol=0)
    # the pass module's own form of the same sampler
    np.testing.assert_array_equal(
        TT._catmull_rom(torch.as_tensor(tex), torch.as_tensor(sp)).numpy(),
        np.moveaxis(got.numpy(), 0, -1))


def test_bilinear_matches_xla_sampler(field):
    tex, uv, _ = field
    got = TT._bilinear(torch.as_tensor(tex), torch.as_tensor(uv)).numpy()
    want = np.asarray(TJ._bilinear(jnp.asarray(tex), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_nearest_is_floor_clamped():
    rng = np.random.default_rng(2)
    tex = rng.random((2, 9, 13)).astype(np.float32)
    sx = rng.uniform(-5, 20, (6, 7)).astype(np.float32)
    sy = rng.uniform(-5, 15, (6, 7)).astype(np.float32)
    got = W.warp_resample_plain(torch.as_tensor(tex), torch.as_tensor(sx),
                                torch.as_tensor(sy), "nearest").numpy()
    xi = np.clip(np.floor(sx).astype(int), 0, 12)
    yi = np.clip(np.floor(sy).astype(int), 0, 8)
    np.testing.assert_array_equal(got, tex[:, yi, xi])


def test_sample_env_matches_reference():
    rng = np.random.default_rng(9)
    env = XJ.latlong_sky()
    dirs = rng.normal(size=(40, 144, 3)).astype(np.float32)
    want = np.asarray(XJ.sample_env(jnp.asarray(env), jnp.asarray(dirs)))
    got = XT.sample_env(torch.as_tensor(env), torch.as_tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # a flat list of directions goes through the same kernel as one row
    flat = XT.sample_env(torch.as_tensor(env),
                         torch.as_tensor(dirs[:3].reshape(-1, 3))).numpy()
    np.testing.assert_array_equal(flat, got[:3].reshape(-1, 3))


def test_sample_pages_matches_reference():
    """The port samples the wrap-padded page atlas as the reference's
    accelerator path does (textures.py:144-152): against that path (its
    warp kernel in interpret mode) within 1e-5; against the CPU gather
    within 2e-5, because the atlas path reduces u to [0, 64) before the
    floor, which moves the bilinear fraction by up to an ulp of |u * 64|
    (1.5e-5 at |uv| < 3) — the reference's two paths differ by the same
    1.47e-5 here."""
    rng = np.random.default_rng(13)
    n = 6
    pages = rng.random((n, XJ.PAGE, XJ.PAGE, 3)).astype(np.float32)
    uv = ((rng.random((40, 144, 2)).astype(np.float32) - 0.3) * 4.0)
    pidx = rng.integers(-1, n, (40, 144)).astype(np.int32)
    args = (jnp.asarray(pages), jnp.asarray(pidx), jnp.asarray(uv))
    gather = np.asarray(XJ.sample_pages(*args))
    fake = [type("D", (), {"platform": "tpu"})()]
    with interpret_mode(WP), \
            mock.patch.object(jax, "devices", lambda *a, **k: fake):
        atlas = np.asarray(XJ.sample_pages(*args))
    got = XT.sample_pages(torch.as_tensor(pages), torch.as_tensor(pidx),
                          torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, atlas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, gather, atol=2e-5, rtol=0)
    assert (got[pidx < 0] == 1.0).all()


def test_texture_bakers_are_the_references():
    assert XT.PAGE == XJ.PAGE
    np.testing.assert_array_equal(XT.latlong_sky(), XJ.latlong_sky())
    np.testing.assert_array_equal(XT.checkerboard(), XJ.checkerboard())
    np.testing.assert_array_equal(XT.noise_texture(seed=4),
                                  XJ.noise_texture(seed=4))
    imgs = [XT.noise_texture(seed=1), np.full((130, 90), 128, np.uint8)]
    np.testing.assert_array_equal(XT.build_texture_pages(imgs),
                                  XJ.build_texture_pages(imgs))


@pytest.mark.parametrize("mode", ["catmull_rom", "bilinear"])
def test_matches_warp_pallas_in_interpret_mode(field, mode):
    """K10's plain version against the TPU kernel itself (interpret mode)
    on the smooth motion field, where its fallback never fires."""
    tex, _, sp = field
    texp = jnp.moveaxis(jnp.asarray(tex), -1, 0)
    fb = jnp.full_like(texp, -9.0)
    with interpret_mode(WP):
        want = np.asarray(WP.warp_resample_pallas(
            texp, jnp.asarray(sp[..., 0]), jnp.asarray(sp[..., 1]), fb,
            mode=mode))
    assert not (want == -9.0).any()
    got = W.warp_resample_plain(_planar(tex), torch.as_tensor(sp[..., 0]),
                                torch.as_tensor(sp[..., 1]), mode).numpy()
    assert np.abs(got - want).max() < 1e-4


def test_check_offsets_refuses_what_32_bit_offsets_cannot_address():
    """K10's launch check (the wrapper runs it before every launch): a
    texture or a target of 2^31 values or more raises ValueError; one
    value fewer passes."""
    tex = torch.zeros((3, 8, 8))
    sx = torch.zeros((4, 8))
    W.check_offsets(tex, sx)
    big_tex = torch.empty((2, 2**15, 2**15), device="meta")
    big_out = torch.empty((2**16, 2**15), device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        W.check_offsets(big_tex, sx)
    with pytest.raises(ValueError, match="2\\^31"):
        W.check_offsets(tex[:1], big_out)
    with pytest.raises(ValueError, match="2\\^31"):
        W.check_offsets(tex[:2], big_out[:, :2**14])
    W.check_offsets(big_tex[:, :, :-1], sx)
    W.check_offsets(tex[:1], big_out.reshape(-1)[:-1].reshape(1, -1))
