"""Shared StandardMaterial-equivalent BSDF math: Lambert diffuse + GGX
specular under the metallic workflow (counterpart of rtsdm_tpu/ops/brdf.py;
reference StandardMaterial.h:68, Rendering/Materials/BxDF.slang).

Directions are unit length; wo points away from the surface toward the
viewer, wi toward the light. Evaluations return f*cos terms.
"""
from __future__ import annotations

import torch

from ..utils.math import dot3, normalize, saturate, true_div

PI = 3.14159265


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * d * d, min=1e-8)


def smith_g(n_dot_v, n_dot_l, alpha):
    def g1(c):
        a2 = alpha * alpha
        return 2.0 * c / torch.clamp(
            c + torch.sqrt(a2 + (1.0 - a2) * c * c), min=1e-8)
    return g1(torch.clamp(n_dot_v, min=1e-4)) \
        * g1(torch.clamp(n_dot_l, min=1e-4))


def fresnel_schlick(v_dot_h, f0=0.04, f90=1.0):
    return f0 + (f90 - f0) * (1.0 - saturate(v_dot_h)) ** 5


def ior_to_f0(ior):
    """Dielectric normal-incidence reflectance from the index of
    refraction (StandardMaterial IoR, MaterialData.slang)."""
    r = (ior - 1.0) / torch.clamp(ior + 1.0, min=1e-4)
    return r * r


def metallic_albedos(base_color, metallic, ior):
    """(diffuse albedo, specular F0): metals tint the specular lobe with
    the base colour and kill the diffuse lobe."""
    m = metallic[..., None] if metallic.dim() < base_color.dim() else metallic
    f0d = ior_to_f0(ior)
    f0d = f0d[..., None] if f0d.dim() < base_color.dim() else f0d
    return base_color * (1.0 - m), f0d * (1.0 - m) + base_color * m


def eval_lobes(diff_albedo, f0, rough, n, wo, wi):
    """f*cos of the diffuse + GGX pair for one light direction: [..., 3]
    colours, [...] scalars, [..., 3] vectors."""
    n_dot_l = dot3(n, wi)
    n_dot_v = torch.clamp(dot3(n, wo), min=1e-4)
    h = normalize(wo + wi)
    n_dot_h = saturate(dot3(n, h))
    v_dot_h = saturate(dot3(wo, h))
    alpha = torch.clamp(rough * rough, min=1e-3)
    valid = n_dot_l > 1e-5
    f = fresnel_schlick(v_dot_h[..., None], f0)
    d = ggx_d(n_dot_h, alpha)
    g = smith_g(n_dot_v, n_dot_l, alpha)
    spec = f * (d * g / torch.clamp(4.0 * n_dot_v * n_dot_l,
                                    min=1e-6))[..., None]
    diff = true_div(diff_albedo, PI)
    return torch.where(valid[..., None], (diff + spec) * n_dot_l[..., None],
                       0.0)
