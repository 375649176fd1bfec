"""HBAO baseline pass (counterpart of rtsdm_tpu/passes/hbao.py; reference
Source/RenderPasses/HBAO/HBAO.ps.slang, HBAO.cpp): horizon-based AO on
4x4-deinterleaved quarter-res linear depth, with a per-slice random
rotation, an NdotV-bias kernel and quadratic distance falloff
(HBAO.ps.slang:97-122, 160-246), and two output channels (falloff-weighted
and plain horizon term). All 16 slices run as one batch (leading axis 16).

Two ways to read the ring's 8 directions x 4 steps of depth taps:
  * Gather: each tap is rounded to a quarter texel and gathered;
  * Shift: each tap's length is quantized onto the static level table of
    ops/ao.py, so a tap is a static per-slice offset chosen per texel by
    its level; all 32 taps come from one call of K6
    (ops/fetch_cuda.fetch_taps_same_class, its plain version on the CPU).
samplingMode "Auto" takes Shift for CUDA tensors and Gather for CPU ones,
as the reference package takes Shift on an accelerator.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import ao as A
from ..ops import ao_shift as S
from ..ops.fetch_cuda import fetch_taps_same_class
from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass
from ..utils.math import (dot3, normalize, saturate, transform_vector,
                          true_div)

NUM_STEPS = 4
NUM_DIRECTIONS = 8
MAX_SHIFT_REACH = 48   # quarter texels; Shift clamps the march length here

# 16 x (sin theta, cos theta, r1, r2): the reference package's frozen table
# (seed 0, numpy's default generator; HBAO.cpp:225-251 uses an mt19937
# stream), generated by the same numpy calls.
_rng = np.random.default_rng(0)
_theta = _rng.uniform(0.0, 2.0 * 3.141, 16)
HBAO_NOISE = np.stack([np.sin(_theta), np.cos(_theta),
                       _rng.uniform(0.0, 1.0, 16),
                       _rng.uniform(0.0, 1.0, 16)], axis=-1).astype(np.float32)
del _rng, _theta

DEPTH_MODE = {"SingleDepth": 0, "DualDepth": 1, "StochasticDepth": 2}


@functools.lru_cache(maxsize=1)
def direction_tables():
    """Per ring direction the static [16, 2] float32 screen direction of
    every slice (the noise rotation applied to the ring angle), evaluated in
    numpy exactly as the reference package does."""
    alpha = 2.0 * 3.141 / NUM_DIRECTIONS
    dir_nps = []
    for i in range(NUM_DIRECTIONS):
        theta = alpha * float(i)
        c_np, s_np = np.cos(theta), np.sin(theta)
        dir_nps.append(np.stack(
            [HBAO_NOISE[:, 0] * c_np - HBAO_NOISE[:, 1] * s_np,
             HBAO_NOISE[:, 0] * s_np + HBAO_NOISE[:, 1] * c_np],
            axis=-1).astype(np.float32))
    return tuple(dir_nps)


def shift_offsets(levels, dir_nps):
    """offs[d][s][l] = (dy, dx): direction d's quarter-texel offset for
    slice s at level radius levels[l] (numpy's rounding of its float32
    product, as in the reference package)."""
    return tuple(
        tuple(tuple((int(round(float(r) * d_np[s, 1])),
                     int(round(float(r) * d_np[s, 0])))
                    for r in levels) for s in range(16))
        for d_np in dir_nps)


@functools.lru_cache(maxsize=1)
def shift_tables():
    """(levels, pad, offs) of the Shift path: the level radii up to
    MAX_SHIFT_REACH, the plane padding, and shift_offsets."""
    levels = A.shift_radius_levels(float(MAX_SHIFT_REACH))
    return (levels, int(np.ceil(levels[-1])),
            shift_offsets(levels, direction_tables()))


@register_pass("HBAO")
class HBAO(RenderPass):
    SCHEMA = dict(radius=1.0, depthMode="SingleDepth", depthBias=0.1,
                  exponent=2.0, samplingMode="Auto")

    def reflect(self, ctx):
        return (PassReflection()
                .add_input("depth", "linear depth, deinterleaved "
                                    "[16, qh, qw]")
                .add_input("depth2", "second-layer linear depth, "
                                     "deinterleaved", optional=True)
                .add_input("normals", "world-space normals (full res)")
                .add_output("ambientMap", "deinterleaved ambient "
                                          "[16, qh, qw, 2]"))

    def _use_shift(self, depth_q) -> bool:
        sm = self.cfg["samplingMode"]
        if sm not in ("Auto", "Shift", "Gather"):
            raise ValueError(f"HBAO: unknown samplingMode {sm!r}")
        return sm == "Shift" or (sm == "Auto" and depth_q.is_cuda)

    def execute(self, ctx, inputs, state=None):
        cam = ctx.scene.camera
        depth_q = inputs["depth"]                 # [16, qh, qw]
        depth2_q = inputs.get("depth2")
        mode = DEPTH_MODE[self.cfg["depthMode"]]
        if mode == 1 and depth2_q is None:
            mode = 0
        dev = depth_q.device

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        radius = f32(self.cfg["radius"])
        neg_inv_rsq = -1.0 / (radius * radius)
        ndotv_bias = f32(self.cfg["depthBias"])
        power = f32(self.cfg["exponent"])

        res = f32([ctx.width, ctx.height])
        inv_res = 1.0 / res
        _, qh, qw = depth_q.shape
        rand = f32(HBAO_NOISE)                    # [16, 4]

        # full-res uv of each deinterleaved pixel (HBAO.ps.slang:137-138)
        s_idx = torch.arange(16, dtype=torch.int32, device=dev)
        qoff = torch.stack([s_idx % 4, s_idx // 4], -1).to(torch.float32)
        qx = torch.arange(qw, dtype=torch.float32, device=dev)
        qy = torch.arange(qh, dtype=torch.float32, device=dev)
        shape = (16, qh, qw)
        px = (qx[None, None, :] * 4.0 + qoff[:, None, None, 0] + 0.5) \
            .expand(shape)
        py = (qy[None, :, None] * 4.0 + qoff[:, None, None, 1] + 0.5) \
            .expand(shape)
        uv = torch.stack([px * inv_res[0], py * inv_res[1]], -1)

        lin_z = depth_q
        view_pos = cam.uv_to_view_space(uv, lin_z)

        # view-space normal at uv: where the normal buffer has the render
        # size the fetch is the 4x4 deinterleave itself
        normal_w = inputs["normals"][..., :3]
        nh, nw = normal_w.shape[:2]
        if (nh, nw) == (ctx.height, ctx.width) and nh % 4 == 0 \
                and nw % 4 == 0:
            n_w = S.deinterleave(normal_w)[:, :qh, :qw]
        else:
            ny = torch.clamp((uv[..., 1] * nh).to(torch.int32), 0, nh - 1)
            nx = torch.clamp((uv[..., 0] * nw).to(torch.int32), 0, nw - 1)
            n_w = normal_w[ny.long(), nx.long()]
        n_v = normalize(transform_vector(cam.view_mat, n_w))
        flip = dot3(view_pos, n_v) > 0.0
        n_v = torch.where(flip[..., None], -n_v, n_v)

        # radius in full-res pixels (HBAO.ps.slang:87-93)
        radius_uv = cam.view_space_radius_to_uv_radius(lin_z, radius)
        radius_px = 0.5 * (radius_uv[..., 0] * res[0]
                           + radius_uv[..., 1] * res[1])
        step_px = true_div(true_div(radius_px, 4.0), float(NUM_STEPS + 1))

        def compute_ao(sample_pos):
            v = sample_pos - view_pos
            vdotv = dot3(v, v)
            ndotv = dot3(n_v, v) / torch.sqrt(torch.clamp(vdotv, min=1e-12))
            angle = saturate(ndotv - ndotv_bias)
            fall_x = saturate(vdotv * neg_inv_rsq + 1.0)
            return torch.stack([angle * fall_x, angle], -1), angle, fall_x

        base_q = torch.stack([qx[None, None, :].expand(shape),
                              qy[None, :, None].expand(shape)], -1)
        sl = s_idx.long()[:, None, None]

        def sample_depth(tex, sq_xy):
            sx = torch.clamp(sq_xy[..., 0], 0, qw - 1).long()
            sy = torch.clamp(sq_xy[..., 1], 0, qh - 1).long()
            return tex[sl, sy, sx]

        dir_nps = direction_tables()
        r0 = rand[:, 2][:, None, None]
        fetched = None
        if self._use_shift(depth_q):
            levels, pad, offs = shift_tables()
            # one padded [n_src, 16, ph, pw] tensor of the plane sets
            planes = S.pad_planes(torch.stack([depth_q, depth2_q])
                                  if mode == 1 else depth_q[None], pad)
            # the march length is the same for every direction, so the
            # level planes are per step
            lvl_steps, r_q_steps = [], []
            rp = r0 * step_px + 1.0
            for _ in range(NUM_STEPS):
                lvl_k = A.shift_level_index(
                    levels, torch.clamp(rp, 1.0, float(MAX_SHIFT_REACH)))
                lvl_steps.append(lvl_k)
                r_q_steps.append(S.level_radius(levels, lvl_k))
                rp = rp + step_px
            fetched = fetch_taps_same_class(planes, torch.stack(lvl_steps),
                                            pad, offs)

        ao = torch.zeros(lin_z.shape + (2,), device=dev)
        dirs = f32(np.stack(dir_nps))[:, :, None, None, :]  # [8, 16, 1, 1, 2]
        for i in range(NUM_DIRECTIONS):
            d_b = dirs[i]
            ray_px = r0 * step_px + 1.0
            for k in range(NUM_STEPS):
                if fetched is not None:
                    t = i * NUM_STEPS + k
                    z1 = fetched[0, t]
                    z2 = fetched[1, t] if mode == 1 else None
                    off = torch.round(r_q_steps[k][..., None] * d_b)
                else:
                    off = torch.round(ray_px[..., None] * d_b)
                    sq = (base_q + off).to(torch.int32)
                    z1 = sample_depth(depth_q, sq)
                    z2 = sample_depth(depth2_q, sq) if mode == 1 else None
                s_uv = uv + off * 4.0 * inv_res
                ao1, angle, fall_x = compute_ao(cam.uv_to_view_space(s_uv,
                                                                     z1))
                if mode == 1:
                    # resample the second layer where the first is past the
                    # radius but in the positive hemisphere (RecomputeAO,
                    # HBAO.ps.slang:122-132, 190-202)
                    need = (angle > 0.0) & (fall_x <= 0.0)
                    ao2, _, _ = compute_ao(cam.uv_to_view_space(s_uv, z2))
                    ao1 = torch.where(need[..., None],
                                      torch.maximum(ao1, ao2), ao1)
                ao = ao + ao1
                ray_px = ray_px + step_px

        ao = ao / float(NUM_DIRECTIONS * NUM_STEPS)
        out = saturate(1.0 - ao * 2.0) ** power
        # early outs (HBAO.ps.slang:140-157): background, sub-pixel radius
        passthru = (lin_z >= cam.far_z) | (radius_px < 1.0)
        return {"ambientMap": torch.where(passthru[..., None], 1.0, out)}, \
            None
