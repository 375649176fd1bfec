"""SVAO with the rasterized stochastic depth map (BASELINE config 2:
SVAO's stochasticDepthImpl 'Raster'), for the benchmark's graph
scripts/SVAO_small_rastersd.py.

StochasticDepthMap — the raster SD pass (counterpart of the port's
passes/stochastic_depth.StochasticDepthMap; reference StochasticDepthMap/
StochasticDepth.ps.slang): the first depth layer sampled onto the SD grid,
then K9's k-slot raster by ops/ref_raster_sd.py, the reference's own cull.

SVAORasterSD — the frozen passes/svao.SVAO that also admits
stochasticDepthImpl 'Raster': the SD map then has no guard band and its
nested graph runs StochasticDepthMap (SVAO.cpp:157-190, 700-723). Every
other mode is the frozen pass's.
"""
from __future__ import annotations

import torch

from ..ops.ref_raster_sd import raster_stochastic_reference
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from . import svao
from .stochastic_depth import _bilinear_sample, _downsample_linear


def _uv_grid(h: int, w: int, *, device):
    """[h, w, 2] texel-centre uv of an h x w grid."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


@register_pass("StochasticDepthMap")
class StochasticDepthMap(RenderPass):
    """Output 'stochasticDepth': [sdH, sdW, SampleCount] view depths,
    linearized to [0, 1] with `linearize` (else linear, far where empty).
    The SD grid is rayMax's shape, else the render size over `divisor`.
    maxPerTile, Implementation and AlphaTest are accepted and change
    nothing, as in the port."""

    SCHEMA = dict(SampleCount=4, CullMode="Back", AlphaTest=True,
                  Implementation="default", Alpha=0.375, RayInterval=True,
                  linearize=True, depthFormat=None, maxPerTile=256,
                  divisor=1)

    def reflect(self, ctx):
        return (PassReflection().add_input("depthMap")
                .add_input("rayMin", optional=True)
                .add_input("rayMax", optional=True)
                .add_output("stochasticDepth"))

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        ray_max = inputs.get("rayMax")
        if ray_max is not None:
            sd_h, sd_w = ray_max.shape
        else:
            d = int(self.cfg["divisor"])
            sd_h, sd_w = -(-ctx.height // d), -(-ctx.width // d)
        lin_full = cam.linearize_depth(inputs["depthMap"])
        div0 = lin_full.shape[1] // max(sd_w, 1)
        if div0 in (1, 2, 4) and lin_full.shape[1] == sd_w * div0 \
                and lin_full.shape[0] == sd_h * div0:
            first_lin = _downsample_linear(lin_full, div0, sd_w, sd_h)
        else:
            first_lin = _bilinear_sample(
                lin_full, _uv_grid(sd_h, sd_w, device=lin_full.device))
        interval = bool(self.cfg["RayInterval"])
        depths = raster_stochastic_reference(
            cam.view_proj_no_jitter, ctx.scene.positions, cam.far_z,
            width=sd_w, height=sd_h, k=int(self.cfg["SampleCount"]),
            alpha=float(self.cfg["Alpha"]), first_depth=first_lin,
            ray_min=inputs.get("rayMin") if interval else None,
            ray_max=ray_max if interval else None,
            cull=self.cfg["CullMode"].lower())
        if self.cfg["linearize"]:
            depths = torch.clamp((depths - cam.near_z)
                                 / (cam.far_z - cam.near_z), 0.0, 1.0)
        return {"stochasticDepth": depths}, None


_SUPPORTED = dict(svao._SUPPORTED, stochasticDepthImpl=("Ray", "Raster"))


@register_pass("SVAORasterSD")
class SVAORasterSD(svao.SVAO):
    def _raster(self) -> bool:
        return self.cfg["stochasticDepthImpl"] == "Raster"

    def _check_supported(self):
        for key, allowed in _SUPPORTED.items():
            if self.cfg[key] not in allowed:
                raise NotImplementedError(
                    f"SVAO: {key}={self.cfg[key]!r} is not ported (only "
                    f"{' or '.join(map(repr, allowed))})")

    def _extra_guard(self) -> int:
        """The SD map's guard band in SD texels: none for the raster map."""
        return 0 if self._raster() else super()._extra_guard()

    def _sd_pass(self):
        if not self._raster():
            return super()._sd_pass()
        return "StochasticDepthMap", {
            "SampleCount": int(self.cfg["stochSamples"]),
            "CullMode": self._cull(),
            "AlphaTest": bool(self.cfg["alphaTest"]),
            "Alpha": 1.5 / int(self.cfg["stochSamples"]),
            "RayInterval": bool(self.cfg["useRayInterval"]),
            "linearize": True, "divisor": int(self.cfg["stochMapDivisor"])}
