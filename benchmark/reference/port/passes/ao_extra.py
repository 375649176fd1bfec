"""AOGuidedBlur, the guided bilateral blur / upsample of the bright and
dark AO channels with their deviation-weighted fusion (reference
AOGuidedBlur/AOGuidedBlur.ps.slang; counterpart of rtsdm_tpu/passes/
ao_extra.py). The port's RTAO is not in this copy: no benchmark graph
runs it."""
from __future__ import annotations

import torch

from ..ops.ao import shift_axis_clamped
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import true_div


def _gauss(offset, variance: float):
    return torch.exp(true_div(-0.5 * offset * offset, variance))


def _upsample_nearest(src, hf: int, wf: int):
    """[hs, ws, C] -> [hf, wf, C] by nearest neighbour: an aligned repeat
    when the ratio is an integer, a gather otherwise."""
    hs, ws = src.shape[:2]
    if (hs, ws) == (hf, wf):
        return src
    if hf % hs == 0 and wf % ws == 0:
        return src.repeat_interleave(hf // hs, 0) \
            .repeat_interleave(wf // ws, 1)
    dev = src.device
    ys = torch.clamp(torch.div(torch.arange(hf, device=dev) * hs, hf,
                               rounding_mode="floor"), 0, hs - 1)
    xs = torch.clamp(torch.div(torch.arange(wf, device=dev) * ws, wf,
                               rounding_mode="floor"), 0, ws - 1)
    return src[ys][:, xs]


@register_pass("AOGuidedBlur")
class AOGuidedBlur(RenderPass):
    """Separable guided blur + bright/dark fusion (AOGuidedBlur.ps.slang).
    Input 'in' (or 'ao2') may be lower-res than 'depth' (or
    'lineardepth'): it is upsampled by nearest neighbour first, which makes
    this the guided upsample of the quarter-res pipeline."""

    SCHEMA = dict(kernelRadius=4, localDeviation=True, enabled=True,
                  clampResults=True)

    DEPTH_VARIANCE = 0.001
    SPATIAL_VARIANCE = 16.4
    DARK_EPSILON = 0.01
    ENHANCE_CONTRAST = 1.0

    def reflect(self, ctx):
        # the reference names are ao2/lineardepth -> color
        # (AOGuidedBlur.cpp:37-40); the repo's graphs use in/depth -> out
        return (PassReflection().add_input("in", optional=True)
                .add_input("depth", optional=True)
                .add_input("ao2", optional=True)
                .add_input("lineardepth", optional=True)
                .add_output("out").add_output("color"))

    def _pass1d(self, ao, ao_sq, depth, axis: int, lo: int, hi: int):
        """One separable direction: depth- and distance-weighted means of
        the AO and its square, taps clamped to [lo, hi]."""
        r = int(self.cfg["kernelRadius"])
        means = torch.zeros_like(ao)
        means_sq = torch.zeros_like(ao)
        wsum = torch.zeros(ao.shape[:2], device=ao.device)
        local_d = torch.clamp(depth, min=1.4e-45)
        for it in range(-r, r + 1):
            s_ao = shift_axis_clamped(ao, axis, it, lo, hi)
            s_sq = shift_axis_clamped(ao_sq, axis, it, lo, hi)
            s_d = shift_axis_clamped(depth, axis, it, lo, hi)
            spatial = _gauss(torch.tensor(float(it), device=ao.device),
                             self.SPATIAL_VARIANCE)
            rel = torch.clamp(torch.abs(s_d / local_d - 1.0), max=1.0)
            w = spatial * _gauss(rel, self.DEPTH_VARIANCE)
            wsum = wsum + w
            means = means + w[..., None] * s_ao
            means_sq = means_sq + w[..., None] * s_sq
        ok = (wsum > 1e-4)[..., None]
        den = torch.clamp(wsum, min=1e-4)[..., None]
        return (torch.where(ok, means / den, ao),
                torch.where(ok, means_sq / den, ao_sq))

    def execute(self, ctx, inputs, state=None):
        src = inputs.get("in", inputs.get("ao2"))
        depth = inputs.get("depth", inputs.get("lineardepth"))
        if src is None or depth is None:
            raise KeyError("AOGuidedBlur needs in/ao2 and depth/lineardepth")
        if src.ndim >= 3 and src.shape[0] == 16:
            raise NotImplementedError(
                "AOGuidedBlur: 4x4-deinterleaved inputs are not in this copy")
        if depth.ndim == 3 and depth.shape[-1] == 1:
            depth = depth[..., 0]
        if src.ndim == 2:
            src = torch.stack([src, src], -1)
        if not self.cfg["enabled"]:
            # the reference blits its input when disabled
            # (AOGuidedBlur.cpp:130-139): the plain mean of bright and dark
            out = src[..., :2].mean(-1)
            return {"out": out, "color": out}, None
        hf, wf = depth.shape
        original = _upsample_nearest(src, hf, wf)[..., :2]
        g = ctx.guard_band
        m, msq = self._pass1d(original, original * original, depth, 1, g,
                              wf - g - 1)
        m, msq = self._pass1d(m, msq, depth, 0, g, hf - g - 1)
        if self.cfg["localDeviation"]:
            dev = torch.abs(original - m)
        else:
            dev = torch.sqrt(torch.clamp(msq - m * m, min=0.0))
        dev_bright = dev[..., 0] * self.ENHANCE_CONTRAST
        dev_dark = torch.clamp(dev[..., 1], min=self.DARK_EPSILON)
        den = torch.clamp(dev_bright + dev_dark, min=1e-8)
        # each channel weighted by the other's deviation
        c = original[..., 0] * (dev_dark / den) \
            + original[..., 1] * (dev_bright / den)
        # clampResults is accepted for the reference scripts; the reference
        # shader's clamp is commented out (AOGuidedBlur.ps.slang:155,201)
        return {"out": c, "color": c}, None
