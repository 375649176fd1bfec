"""4x4 de/interleaving (counterpart of rtsdm_tpu/passes/interleave.py;
reference Source/RenderPasses/DeinterleaveTexture/Deinterleave.slang and
InterleaveTexture.ps.slang).

slice = (y%4)*4 + (x%4); quarter-res slice s holds the full-res pixels
(4*qx + s%4, 4*qy + s//4): a reshape and a transpose."""
from __future__ import annotations

import torch

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass


def deinterleave_4x4(tex):
    """[H,W(,C)] -> [16, ceil(H/4), ceil(W/4)(,C)]; H and W are padded up to
    multiples of 4 by repeating the last row and column."""
    h, w = tex.shape[:2]
    ph, pw = (-h) % 4, (-w) % 4
    if ph or pw:
        tex = torch.cat([tex, tex[-1:].expand((ph,) + tex.shape[1:])], 0)
        tex = torch.cat([tex, tex[:, -1:].expand(
            (tex.shape[0], pw) + tex.shape[2:])], 1)
    qh, qw = tex.shape[0] // 4, tex.shape[1] // 4
    t = tex.reshape((qh, 4, qw, 4) + tex.shape[2:])
    t = torch.movedim(t, (1, 3), (0, 1))            # [4(y),4(x),qh,qw,...]
    return t.reshape((16, qh, qw) + tex.shape[2:])


def interleave_4x4(slices, height: int, width: int):
    """[16, qh, qw(,C)] -> [height, width(,C)] (the 4x4 grid cropped)."""
    qh, qw = slices.shape[1], slices.shape[2]
    t = slices.reshape((4, 4, qh, qw) + slices.shape[3:])
    t = torch.movedim(t, (0, 1), (1, 3))            # [qh,4,qw,4,...]
    t = t.reshape((qh * 4, qw * 4) + slices.shape[3:])
    return t[:height, :width]


@register_pass("DeinterleaveTexture")
class DeinterleaveTexture(RenderPass):
    SCHEMA = dict()

    def reflect(self, ctx):
        return PassReflection().add_input("texIn").add_output("texOut")

    def execute(self, ctx, inputs, state=None):
        return {"texOut": deinterleave_4x4(inputs["texIn"])}, None


@register_pass("InterleaveTexture")
class InterleaveTexture(RenderPass):
    SCHEMA = dict()

    def reflect(self, ctx):
        return PassReflection().add_input("texIn").add_output("texOut")

    def execute(self, ctx, inputs, state=None):
        return {"texOut": interleave_4x4(inputs["texIn"], ctx.height,
                                         ctx.width)}, None
