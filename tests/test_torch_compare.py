"""The image metrics of rtsdm_tpu_torch/utils/compare.py (MSE, RMSE, MAE,
MAPE, SSIM and the LDR-FLIP error map) against rtsdm_tpu/utils/compare.py
on the CPU, on seeded numpy images: gray and colour, a test image that is
the reference plus seeded noise, and the same image twice.

Tolerances: the MSE family within 1e-6 relative (float32 means summed in
another order: measured max 2.8e-7); SSIM within 1e-5 (its Gaussian blur
is a conv2d here and a weighted sum of shifted copies there: measured max
1.8e-7 off); the FLIP map within 1e-4 per pixel (the CSF and feature
filters are conv2d in both, with other summation orders, and the cube
root is a power here: measured max 2.2e-5) and its mean within 1e-5
(measured 3.7e-8).
"""
import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rtsdm_tpu.utils import compare as CJ  # noqa: E402
from rtsdm_tpu_torch.utils import compare as C  # noqa: E402


def _images(shape, seed):
    """(test, reference): a smooth seeded reference in [0, 1] and the same
    plus seeded noise, clipped."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ref = 0.5 + 0.4 * np.sin(xx / 7.0 + seed) * np.cos(yy / 5.0)
    if len(shape) == 3:
        ref = np.stack([ref * (0.6 + 0.2 * c) for c in range(shape[2])], -1)
    ref = ref.astype(np.float32)
    test = np.clip(ref + rng.normal(0.0, 0.05, ref.shape), 0.0, 1.0)
    return test.astype(np.float32), ref


SHAPES = [(48, 64), (40, 56, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["mse", "rmse", "mae", "mape"])
def test_error_family_matches_reference(shape, metric):
    a, b = _images(shape, 1)
    got = float(getattr(C, metric)(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(getattr(CJ, metric)(jnp.asarray(a), jnp.asarray(b)))
    assert want > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert C.compare(a, b, metric) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_ssim_matches_reference(shape):
    a, b = _images(shape, 2)
    got = float(C.ssim(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(CJ.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert 0.0 < want < 0.99
    assert abs(got - want) <= 1e-5
    assert float(C.ssim(torch.as_tensor(b), torch.as_tensor(b))) \
        == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_flip_error_matches_reference(shape):
    a, b = _images(shape, 3)
    got = C.flip_error(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(CJ.flip_error(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == shape[:2]
    assert want.mean() > 0.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert abs(C.compare(a, b, "flip") - CJ.compare(a, b, "flip")) <= 1e-5
    same = C.flip_error(torch.as_tensor(b), torch.as_tensor(b)).numpy()
    assert np.abs(same).max() <= 1e-6


def test_quality_tool_row_on_a_small_config():
    """rtsdm_tpu_torch.tools.quality_ssim's per-configuration row, on
    CornellBox 64x64 with two RTAO frames: every SSIM in [-1, 1], and the
    oracle row that needs the SD trace's XLA tier naming the ROADMAP item
    it waits for; config 5's row no longer waits."""
    from rtsdm_tpu_torch.tools import quality_ssim as Q
    row = Q.run_config(dict(name="small", scene="CornellBox", width=64,
                            height=64, divisor=4, impl="Ray", ref_scale=1),
                       "cpu", 2)
    assert row["resolution"] == "64x64" and row["triangles"] == 36
    ssims = {k: v for k, v in row.items() if k.startswith("ssim_")}
    assert "ssim_ray_sd_vs_rtao2" in ssims
    assert "item 9" in ssims.pop("ssim_pallas_vs_xla_oracle")
    assert all(-1.0 <= v <= 1.0 for v in ssims.values()), ssims
    assert row["ssim_config_impl_vs_raytraced"] == \
        row["ssim_ray_sd_vs_raytraced"]
    assert 0.0 <= row["mean_abs_diff_ray_sd_vs_raytraced"] < 0.5
    assert set(Q.WAITING) == {"ssim_pallas_vs_xla_oracle"}


def test_quality_tool_config5_row_on_a_small_scene():
    """Config 5's row (run_config5_taa_stability: scripts/SVAO_small.py
    along the orbiting camera, the clock playing) on CornellBox 48x48 for
    six frames: the SSIM of ShadedTAA's consecutive frames from frame 4 on,
    each in [-1, 1], and their mean."""
    from rtsdm_tpu_torch.tools import quality_ssim as Q
    row = Q.run_config5_taa_stability("cpu", scene="CornellBox", width=48,
                                      height=48, frames=6)
    assert row["resolution"] == "48x48" and row["triangles"] == 36
    sims = row["consecutive_frame_ssim"]
    assert len(sims) == 1 and all(-1.0 <= v <= 1.0 for v in sims)
    assert row["mean_frame_ssim"] == sum(sims) / len(sims)
    assert row["target"] == 0.9
