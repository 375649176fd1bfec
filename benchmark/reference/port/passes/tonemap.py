"""ToneMapper (counterpart of rtsdm_tpu/passes/tonemap.py; reference
Source/RenderPasses/ToneMapper/): the operator table of ToneMapping.ps.slang
(Linear, Reinhard, ReinhardModified, HejiHableAlu, HableUc2, Aces), auto
exposure (log2-average luminance, key 0.042), manual photographic exposure
and white balance (CCT -> Bradford adaptation to D65 in Rec.709, built on
the host in float64 as the reference package does).
"""
from __future__ import annotations

import numpy as np
import torch

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import saturate, transform_vector

_EXPOSURE_KEY = 0.042


def _lum(c):
    # the reference's calcLuminance uses Rec.601 weights
    return c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114


def _reinhard(color):
    l = torch.clamp(_lum(color), min=1e-8)
    return color * ((l / (l + 1.0)) / l)[..., None]


def _reinhard_modified(color, white_max):
    l = torch.clamp(_lum(color), min=1e-8)
    r = l * (1.0 + l / (white_max * white_max)) * (1.0 + l)
    return color * (r / l)[..., None]


def _heji_hable_alu(color):
    x = torch.clamp(color - 0.004, min=0.0)
    x = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return x ** 2.2  # result includes sRGB conversion; undo to stay linear


def _uc2_curve(x):
    a, b, c, d, e, f = 0.22, 0.3, 0.1, 0.2, 0.01, 0.3
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def _hable_uc2(color, white_scale):
    c = _uc2_curve(2.0 * color)
    return c * (1.0 / _uc2_curve(white_scale))  # a host float, as the ref


def _aces(color):
    # Narkowicz ACES fit; the 0.6 pre-scale cancels the fit's pre-exposure
    color = color * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return saturate((color * (a * color + b)) / (color * (c * color + d) + e))


# --- white balance: CCT -> RGB transform (standard colorimetry) -------------

_XYZ_TO_709 = np.array([[3.2409699, -1.5373832, -0.4986108],
                        [-0.9692436, 1.8759675, 0.0415551],
                        [0.0556301, -0.2039770, 1.0569715]], np.float64)
_709_TO_XYZ = np.linalg.inv(_XYZ_TO_709)
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                      [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]], np.float64)
_D65_XY = (0.31271, 0.32902)


def _cct_to_xy(t):
    """Planckian locus approximation (Kim et al. cubic spline, the standard
    formula the reference's ColorUtils also uses)."""
    t = float(np.clip(t, 1667.0, 25000.0))
    if t < 4000.0:
        x = (-0.2661239e9 / t ** 3 - 0.2343589e6 / t ** 2
             + 0.8776956e3 / t + 0.179910)
    else:
        x = (-3.0258469e9 / t ** 3 + 2.1070379e6 / t ** 2
             + 0.2226347e3 / t + 0.240390)
    if t < 2222.0:
        y = (-1.1063814 * x ** 3 - 1.34811020 * x ** 2
             + 2.18555832 * x - 0.20219683)
    elif t < 4000.0:
        y = (-0.9549476 * x ** 3 - 1.37418593 * x ** 2
             + 2.09137015 * x - 0.16748867)
    else:
        y = (3.0817580 * x ** 3 - 5.87338670 * x ** 2
             + 3.75112997 * x - 0.37001483)
    return x, y


def white_balance_transform(cct: float) -> np.ndarray:
    """Rec.709 3x3 adapting white point `cct` to D65 (Bradford CAT)."""
    def xy_to_lms(xy):
        x, y = xy
        xyz = np.array([x / y, 1.0, (1.0 - x - y) / y], np.float64)
        return _BRADFORD @ xyz

    src = xy_to_lms(_cct_to_xy(cct))
    dst = xy_to_lms(_D65_XY)
    cat = np.linalg.inv(_BRADFORD) @ np.diag(dst / src) @ _BRADFORD
    return (_XYZ_TO_709 @ cat @ _709_TO_XYZ).astype(np.float32)


@register_pass("ToneMapper")
class ToneMapper(RenderPass):
    SCHEMA = dict(outputSize="Default", useSceneMetadata=True,
                  exposureCompensation=0.0, autoExposure=False,
                  filmSpeed=100.0, whiteBalance=False, whitePoint=6500.0,
                  operator="Linear", clamp=False, whiteMaxLuminance=1.0,
                  whiteScale=11.2, fNumber=1.0, shutter=1.0,
                  exposureMode="AperturePriority")

    def reflect(self, ctx):
        return PassReflection().add_input("src").add_output("dst")

    def execute(self, ctx, inputs, state=None):
        if self.cfg["outputSize"] != "Default":
            raise NotImplementedError("ToneMapper: only outputSize="
                                      "'Default' is ported")
        c = inputs["src"]
        if c.dim() == 2:
            # single-channel source: D3D samples R32Float as (r, 0, 0, 1)
            c = torch.stack([c, torch.zeros_like(c), torch.zeros_like(c)], -1)
        c = c[..., :3]

        if self.cfg["autoExposure"]:
            # log2-average luminance == the highest mip of the log-luminance
            # texture (ToneMapping.ps.slang kLuminanceLod)
            avg = torch.exp2(torch.mean(torch.log2(
                torch.clamp(_lum(c), min=1e-6))))
            c = c * (torch.full((), _EXPOSURE_KEY, device=c.device) / avg)
            manual = 1.0
        else:
            manual = ((1.0 / 100.0) * float(self.cfg["filmSpeed"])
                      / (float(self.cfg["shutter"])
                         * float(self.cfg["fNumber"]) ** 2))
        scale = 2.0 ** float(self.cfg["exposureCompensation"]) * manual
        if scale != 1.0:        # a multiply by 1.0 is the identity
            c = c * scale

        if self.cfg["whiteBalance"]:
            m = torch.as_tensor(white_balance_transform(
                float(self.cfg["whitePoint"])), device=c.device)
            c = transform_vector(m, c)

        op = self.cfg["operator"]
        if op == "Aces":
            c = _aces(c)
        elif op == "Reinhard":
            c = _reinhard(c)
        elif op == "ReinhardModified":
            c = _reinhard_modified(c, float(self.cfg["whiteMaxLuminance"]))
        elif op == "HejiHableAlu":
            c = _heji_hable_alu(c)
        elif op == "HableUc2":
            c = _hable_uc2(c, float(self.cfg["whiteScale"]))
        elif op != "Linear":
            raise ValueError(f"unknown tone-map operator '{op}'")
        if self.cfg["clamp"]:
            c = saturate(c)
        return {"dst": c}, None
