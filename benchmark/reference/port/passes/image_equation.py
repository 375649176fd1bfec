"""ImageEquation (counterpart of rtsdm_tpu/passes/image_equation.py;
reference ImageEquation.cpp:73-77).

The formula ('I0[xy].r * I1[xy]', 'I0[xy].rrra', ...) is evaluated once
over whole tensors. D3D sampling rules apply: reading channels beyond a
texture's width gives g = b = 0, a = 1.
"""
from __future__ import annotations

import torch

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass

_SWIZZLE = {"r": 0, "g": 1, "b": 2, "a": 3, "x": 0, "y": 1, "z": 2, "w": 3}


class _Img:
    """[H, W] or [H, W, C] as an rgba-swizzleable value."""

    def __init__(self, arr):
        if arr.dim() == 2:
            arr = arr[..., None]
        arr = arr.to(torch.float32)
        h, w, c = arr.shape
        chans = [arr[..., i] if i < c else
                 (torch.ones((h, w), device=arr.device) if i == 3
                  else torch.zeros((h, w), device=arr.device))
                 for i in range(4)]
        self._rgba = torch.stack(chans, -1)

    def __getitem__(self, _key):  # I0[xy]
        return self

    def __getattr__(self, name):
        if name.startswith("_") or not all(ch in _SWIZZLE for ch in name):
            raise AttributeError(name)
        idx = [_SWIZZLE[ch] for ch in name]
        if len(idx) == 1:
            return self._rgba[..., idx[0]]
        return torch.stack([self._rgba[..., i] for i in idx], -1)

    # arithmetic on the full rgba value; a 2-d (single-channel) operand
    # broadcasts per channel, as HLSL scalar * vector does
    def _pair(self, other):
        a = self._rgba
        b = other._rgba if isinstance(other, _Img) else other
        if isinstance(b, torch.Tensor) and b.dim() == 2:
            b = b[..., None]
        return a, b

    def __mul__(self, o): a, b = self._pair(o); return a * b
    def __rmul__(self, o): a, b = self._pair(o); return b * a
    def __add__(self, o): a, b = self._pair(o); return a + b
    def __radd__(self, o): a, b = self._pair(o); return b + a
    def __sub__(self, o): a, b = self._pair(o); return a - b
    def __rsub__(self, o): a, b = self._pair(o); return b - a
    def __truediv__(self, o): a, b = self._pair(o); return a / b
    def __rtruediv__(self, o): a, b = self._pair(o); return b / a
    def __neg__(self): return -self._rgba


_FORMAT_CHANNELS = {"RGBA32Float": 4, "RG32Float": 2, "R32Float": 1,
                    "RGBA8Unorm": 4, "R8Unorm": 1}


@register_pass("ImageEquation")
class ImageEquation(RenderPass):
    SCHEMA = dict(formula="I0[xy]", format="RGBA32Float")

    MAX_INPUTS = 4

    def reflect(self, ctx):
        r = PassReflection()
        for i in range(self.MAX_INPUTS):
            r.add_input(f"I{i}", optional=True)
        return r.add_output("out")

    def execute(self, ctx, inputs, state=None):
        # the reference's term language as a Python expression: inputs
        # I0..I3, math functions, pixel coordinates x/y and the clock time
        dev = next((v.device for v in inputs.values()), None)
        h, w = ctx.height, ctx.width
        xg = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
            .expand(h, w)
        yg = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
            .expand(h, w)

        def _vec(*chans):
            return torch.stack([torch.as_tensor(c, dtype=torch.float32,
                                                device=dev).expand(h, w)
                                for c in chans], -1)

        env = {"xy": None, "abs": torch.abs, "min": torch.minimum,
               "max": torch.maximum, "sqrt": torch.sqrt, "pow": torch.pow,
               "sin": torch.sin, "cos": torch.cos, "exp": torch.exp,
               "floor": torch.floor, "frac": lambda a: a - torch.floor(a),
               "x": xg, "y": yg,
               "time": torch.tensor(float(ctx.time), device=dev),
               "float2": _vec, "float3": _vec, "float4": _vec}
        for k, v in inputs.items():
            env[k] = _Img(v)
        result = eval(self.cfg["formula"],  # noqa: S307
                      {"__builtins__": {}}, env)
        if isinstance(result, _Img):
            result = result._rgba
        result = torch.as_tensor(result, dtype=torch.float32, device=dev)
        if result.dim() == 2:
            result = result[..., None]
        n = _FORMAT_CHANNELS.get(self.cfg["format"], 4)
        c = result.shape[-1]
        if c < n:
            hh, ww = result.shape[:2]
            result = torch.stack(
                [result[..., i] if i < c else
                 (torch.ones((hh, ww), device=dev) if i == 3
                  else torch.zeros((hh, ww), device=dev))
                 for i in range(n)], -1)
        return {"out": result[..., :n]}, None
