"""AO baselines and post-processing (counterpart of rtsdm_tpu/passes/
ao_extra.py). Ported so far: RTAO, the ray-traced AO ground truth
(reference RTAO/Ray.rt.slang:100-128: a cosine-hemisphere ray a pixel
through ops/rt.closest_hit, exponential falloff), and AOGuidedBlur, the
guided bilateral blur / upsample of the bright and dark AO channels with
their deviation-weighted fusion (reference AOGuidedBlur/
AOGuidedBlur.ps.slang). VAO and AOVarianceFix are still to be ported
(ROADMAP queue 1)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import rt
from ..ops.ao import shift_axis_clamped
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import cross, normalize, true_div
from .interleave import deinterleave_4x4, interleave_4x4


def _cosine_dirs(n: int, seed: int = 11):
    """The cosine-weighted hemisphere sample table [n, 3] (float32), drawn
    from default_rng(seed) as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    u1 = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=n).astype(np.float32)
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    return np.stack([r * np.cos(phi), r * np.sin(phi), np.sqrt(1.0 - u1)],
                    -1)


_U32 = 0xFFFFFFFF


def _jenkins(x):
    """Jenkins' one-at-a-time mix on uint32 values held in int64 (PyTorch
    has no full uint32 arithmetic): every step wraps to 32 bits and the
    right shifts are logical."""
    x = x & _U32
    x = (x + (x << 10)) & _U32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _U32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & _U32
    return x


@register_pass("RTAO")
class RTAO(RenderPass):
    """Ray-traced AO: one cosine-hemisphere ray a pixel from the G-buffer's
    world position along its face normal's hemisphere, the sample picked
    per pixel and frame by a Jenkins hash; a hit within maxAORayTHit
    darkens the pixel by the exponential falloff of its distance."""

    SCHEMA = dict(maxAORayTHit=0.5, maxTheoreticalTHit=0.5,
                  applyExponentialFalloff=True,
                  exponentialFalloffDecayConstant=2.0,
                  minimumAmbientIllumination=0.07, normalScale=0.01,
                  numSamples=1, sampleTableSize=256, chunk=256)

    def reflect(self, ctx):
        return (PassReflection().add_input("wPos").add_input("faceNormal")
                .add_output("ambient").add_output("rayDistance"))

    def execute(self, ctx, inputs, state=None):
        pos = inputs["wPos"]
        dev = pos.device
        valid = pos[..., 3] > 0.0
        p = pos[..., :3]
        n = inputs["faceNormal"][..., :3]
        h, w = valid.shape
        # tangent frame (Ray.rt.slang getTangentVector)
        helper = torch.where(torch.abs(n[..., 0:1]) > 0.9,
                             torch.tensor([0.0, 1.0, 0.0], device=dev),
                             torch.tensor([1.0, 0.0, 0.0], device=dev))
        bitan = normalize(cross(n, helper))
        tan = cross(bitan, n)

        size = int(self.cfg["sampleTableSize"])
        table = torch.as_tensor(_cosine_dirs(size), device=dev)
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        seed = _jenkins(torch.full_like(xx, int(ctx.frame_index) & _U32))
        idx = _jenkins(xx * 449 + yy * 2857 + seed) % size
        rd = table[idx]
        dirs = normalize(tan * rd[..., 0:1] + bitan * rd[..., 1:2]
                         + n * rd[..., 2:3])
        origins = (p + n * float(self.cfg["normalScale"])).reshape(-1, 3)
        tmax_v = float(self.cfg["maxAORayTHit"])
        t, tid = rt.closest_hit(ctx.scene, origins, dirs.reshape(-1, 3),
                                torch.full((h * w,), 1e-3, device=dev),
                                torch.full((h * w,), tmax_v, device=dev),
                                chunk=int(self.cfg["chunk"]))
        hit = (tid >= 0).reshape(h, w)
        t = t.reshape(h, w)
        occl = torch.ones((h, w), device=dev)
        if self.cfg["applyExponentialFalloff"]:
            tt = true_div(t, float(self.cfg["maxTheoreticalTHit"]))
            lam = float(self.cfg["exponentialFalloffDecayConstant"])
            occl = torch.exp(-lam * tt * tt)
        min_amb = float(self.cfg["minimumAmbientIllumination"])
        amb = torch.where(hit, 1.0 - (1.0 - min_amb) * occl, 1.0)
        amb = torch.where(valid, amb, 1.0)
        dist = torch.where(hit, t, tmax_v)
        return {"ambient": amb, "rayDistance": dist}, None


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
        # the reference graph's form: 4x4-deinterleaved texture arrays
        # ([16, qh, qw, ...]); blurred interleaved, handed back deinterleaved
        deint = src.ndim >= 3 and src.shape[0] == 16
        if deint:
            fh, fw = src.shape[1] * 4, src.shape[2] * 4
            src = interleave_4x4(src, fh, fw)
            if depth.ndim >= 3 and depth.shape[0] == 16:
                depth = interleave_4x4(depth, fh, fw)
        if depth.ndim == 3 and depth.shape[-1] == 1:
            depth = depth[..., 0]
        if src.ndim == 2:
            src = torch.stack([src, src], -1)
        if not self.cfg["enabled"]:
            # the reference blits its input when disabled
            # (AOGuidedBlur.cpp:130-139): the plain mean of bright and dark
            out = src[..., :2].mean(-1)
            out = deinterleave_4x4(out) if deint else out
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
        c = deinterleave_4x4(c) if deint else c
        return {"out": c, "color": c}, None
