"""DownsamplePass and AOGuidedBlur (the quarter-res AO path of BASELINE
config 4, scripts/SVAO_quarter.py) against rtsdm_tpu on the CPU, on seeded
numpy inputs.

Tolerances: DownsamplePass's point and min modes are bit-exact, its mean
within 5e-7 relative (a float32 sum of a block in another order; measured
2.2e-7); AOGuidedBlur within 5e-6 (float32 sums of nine weighted taps in
each direction, exp of the depth weights and, without localDeviation, the
square root of the blurred moments; measured max 2.0e-6).
"""
import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rtsdm_tpu.passes.ao_extra import AOGuidedBlur as BlurJ  # noqa: E402
from rtsdm_tpu.passes.pipeline_misc import \
    DownsamplePass as DownJ  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RC_J  # noqa: E402
from rtsdm_tpu_torch.passes.ao_extra import AOGuidedBlur  # noqa: E402
from rtsdm_tpu_torch.passes.interleave import deinterleave_4x4  # noqa: E402
from rtsdm_tpu_torch.passes.pipeline_misc import \
    DownsamplePass  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402

BLUR_ATOL = 5e-6


def _run(pass_t, pass_j, inputs, w=8, h=8, guard=0):
    """Both passes on the same numpy inputs; (port output, JAX output)."""
    got, _ = pass_t.execute(
        RenderContext(width=w, height=h, dictionary={"guardBand": guard}),
        {k: torch.as_tensor(v) for k, v in inputs.items()})
    want, _ = pass_j.execute(
        RC_J(width=w, height=h, dictionary={"guardBand": guard}),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("mode", ["point", "min", "mean"])
@pytest.mark.parametrize("factor,shape", [(4, (27, 38)), (3, (20, 17, 3))])
def test_downsample_matches_reference(mode, factor, shape):
    """A size that is not a multiple of the factor is cropped first."""
    rng = np.random.default_rng(factor)
    x = rng.uniform(0.1, 50.0, shape).astype(np.float32)
    props = {"factor": factor, "mode": mode}
    got, want = _run(DownsamplePass(props), DownJ(props), {"input": x})
    g, w = got["output"], want["output"]
    assert g.shape == w.shape == (shape[0] // factor, shape[1] // factor) \
        + shape[2:]
    if mode == "mean":
        np.testing.assert_allclose(g, w, rtol=5e-7, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


def _blur_inputs(hs, ws, hf, wf, seed):
    rng = np.random.default_rng(seed)
    bright = rng.uniform(0.2, 1.0, (hs, ws)).astype(np.float32)
    dark = (bright * rng.uniform(0.5, 1.0, (hs, ws))).astype(np.float32)
    # two depth planes meeting along a column: the depth weights cut there
    depth = np.where(np.arange(wf)[None, :] < wf // 2, 2.0, 3.5) \
        + rng.uniform(0.0, 0.004, (hf, wf))
    return np.stack([bright, dark], -1), depth.astype(np.float32)


@pytest.mark.parametrize("src_shape,guard", [
    ((8, 12), 0),        # integer ratio 4: the aligned repeat
    ((7, 11), 0),        # 32 / 7 and 48 / 11: the nearest gather
    ((8, 12), 3),        # taps clamped to the guard band's interior
    ((32, 48), 2)])      # same size, no upsample
def test_guided_blur_matches_reference(src_shape, guard):
    ao, depth = _blur_inputs(*src_shape, 32, 48, seed=sum(src_shape) + guard)
    got, want = _run(AOGuidedBlur({}), BlurJ({}), {"in": ao, "depth": depth},
                     w=48, h=32, guard=guard)
    assert got["out"].shape == want["out"].shape == (32, 48)
    np.testing.assert_allclose(got["out"], want["out"], atol=BLUR_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got["color"], got["out"])
    assert not np.allclose(got["out"], ao[..., 0].mean())


@pytest.mark.parametrize("props", [{"localDeviation": False},
                                   {"kernelRadius": 2}])
def test_guided_blur_options_match_reference(props):
    """The deviation from the blurred moments, and a narrower kernel, on
    the reference's channel names (ao2, lineardepth [H, W, 1])."""
    ao, depth = _blur_inputs(8, 12, 32, 48, seed=5)
    got, want = _run(AOGuidedBlur(props), BlurJ(props),
                     {"ao2": ao, "lineardepth": depth[..., None]},
                     w=48, h=32)
    np.testing.assert_allclose(got["color"], want["color"], atol=BLUR_ATOL,
                               rtol=0)


def test_guided_blur_deinterleaved_matches_reference():
    """The reference graph's 4x4-deinterleaved form ([16, qh, qw, 2] AO and
    [16, qh, qw] depth): blurred interleaved, handed back deinterleaved."""
    ao, depth = _blur_inputs(32, 48, 32, 48, seed=7)
    ao_d = deinterleave_4x4(torch.as_tensor(ao)).numpy()
    depth_d = deinterleave_4x4(torch.as_tensor(depth)).numpy()
    got, want = _run(AOGuidedBlur({}), BlurJ({}),
                     {"in": ao_d, "depth": depth_d}, w=48, h=32)
    assert got["out"].shape == want["out"].shape == (16, 8, 12)
    np.testing.assert_allclose(got["out"], want["out"], atol=BLUR_ATOL,
                               rtol=0)


@pytest.mark.parametrize("channels", [1, 2])
def test_guided_blur_disabled_matches_reference(channels):
    """enabled=False blits the mean of bright and dark at the input's size
    (a one-channel input is its own bright and dark)."""
    ao, depth = _blur_inputs(8, 12, 32, 48, seed=9)
    src = ao if channels == 2 else ao[..., 0]
    got, want = _run(AOGuidedBlur({"enabled": False}),
                     BlurJ({"enabled": False}), {"in": src, "depth": depth})
    assert got["out"].shape == want["out"].shape == (8, 12)
    np.testing.assert_array_equal(got["out"], want["out"])


def test_guided_blur_needs_both_inputs():
    ao, _ = _blur_inputs(4, 4, 4, 4, seed=1)
    with pytest.raises(KeyError):
        AOGuidedBlur({}).execute(RenderContext(width=4, height=4),
                                 {"in": torch.as_tensor(ao)})
