"""The ray-trace helpers the reference keeps from the port's ops/rt_cuda.py
(counterpart of rtsdm_tpu/ops/rt_pallas.py): 8x32 tile ordering, the
per-frame triangle packing (shared-origin rows, component-major rows and
chunk boxes), the stochastic-depth hash and key, the packed-slot decode,
and K8's pair test. The traces themselves are the reference's own:
ops/ref_sd_trace.py (K5's and K7's function) and ops/ref_any_hit.py
(K8's); the port's kernel wrappers, chunk lists and culls are not in this
copy.
"""
from __future__ import annotations

import torch

from ..utils.math import true_div

RB = 256                  # rays (or pixels) per tile
TC = 128                  # triangles per chunk
TILE_RH, TILE_RW = 8, 32  # tile shape (TILE_RH * TILE_RW == RB)
PACK_W = 16               # floats a packed triangle: nt tp | bt acc | ct
                          # reject | mask + padding (csrc/sd_trace.cu)
INVALID = 2**31 - 1       # empty reservoir slot
EPS_DET = 1e-9


# ---------------------------------------------------------------------------
# 8x32 tile ordering
# ---------------------------------------------------------------------------

def pad_tile(a, fill=0.0):
    """Pad [H,W(,C)] at the high end to (8, 32) multiples with `fill`;
    returns (padded, (H, W))."""
    h, w = a.shape[:2]
    ph, pw = (-h) % TILE_RH, (-w) % TILE_RW
    if ph or pw:
        pads = (0, 0) * (a.ndim - 2) + (0, pw, 0, ph)
        a = torch.nn.functional.pad(a, pads, value=fill)
    return a, (h, w)


def tile_flatten(a):
    """[H,W(,C)] -> [H*W(,C)] in 8x32-tile order (H, W multiples of 8, 32):
    each tile of RB consecutive entries is a compact 8x32 texel block."""
    h, w = a.shape[:2]
    t = a.reshape((h // TILE_RH, TILE_RH, w // TILE_RW, TILE_RW)
                  + a.shape[2:])
    return t.transpose(1, 2).reshape((h * w,) + a.shape[2:])


def tile_unflatten(a, h: int, w: int):
    t = a.reshape((h // TILE_RH, w // TILE_RW, TILE_RH, TILE_RW)
                  + a.shape[1:])
    return t.transpose(1, 2).reshape((h, w) + a.shape[1:])


# ---------------------------------------------------------------------------
# triangle packing
# ---------------------------------------------------------------------------

def _cross_rows(a, b):
    """Cross product of component-major [3, N] rows."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def prep_triangles(scene, alpha_test: bool = True):
    """Component-major padded triangle arrays [3, Tp] (v0, e1, e2) + flags
    [3, Tp] (accept back face, reject, alpha mask as a float-held 16-bit
    bitmap). Padding slots are rejected; back faces are accepted for
    double-sided and alpha-tested materials (SVAO/Common.slang:695)."""
    pos = scene.positions
    t = pos.shape[0]
    tp = t + (-t) % TC
    mid = scene.material_id.long()
    is_alpha = scene.mat_alpha_mode[mid] == 1
    acc = (scene.mat_double_sided[mid] | is_alpha).to(torch.float32)
    if alpha_test:
        mask = torch.where(is_alpha, scene.tri_alpha_mask, 0xFFFF)
    else:
        mask = torch.full((t,), 0xFFFF, dtype=torch.int32, device=pos.device)

    def pad_t(a, value=0.0):
        pads = (0, 0) * (a.ndim - 1) + (0, tp - t)
        return torch.nn.functional.pad(a, pads, value=value)

    v0 = pad_t(pos[:, 0]).T
    e1 = pad_t(pos[:, 1] - pos[:, 0]).T
    e2 = pad_t(pos[:, 2] - pos[:, 0]).T
    flags = torch.stack([pad_t(acc),
                         pad_t(torch.zeros_like(acc), value=1.0),
                         pad_t(mask.to(torch.float32))])
    return v0, e1, e2, flags


def shared_origin_rows(v0t, e1t, e2t, origin):
    """Per-triangle rows for rays sharing one origin. With tv = origin - v0
    the Möller-Trumbore terms are d.nt = det, d.bt = u*det, d.ct = v*det
    and tp = t*det (scalar triple products). Returns (nt, bt, ct, tp)."""
    tv = origin.reshape(3, 1) - v0t
    nt = _cross_rows(e2t, e1t)
    bt = _cross_rows(e2t, tv)
    ct = _cross_rows(tv, e1t)
    c = _cross_rows(e1t, e2t)
    tp = (tv[0] * c[0] + tv[1] * c[1] + tv[2] * c[2])[None]
    return nt, bt, ct, tp


def chunk_aabbs(v0t, e1t, e2t, flags):
    """Chunk AABBs [8, n_chunks] (rows 0-2 min, 3-5 max); rejected
    triangles do not extend the bounds."""
    n_chunks = v0t.shape[1] // TC
    v0 = v0t.T.reshape(n_chunks, TC, 3)
    corners = torch.stack([v0, v0 + e1t.T.reshape(n_chunks, TC, 3),
                           v0 + e2t.T.reshape(n_chunks, TC, 3)], 2)
    rej = (flags[1].reshape(n_chunks, TC) > 0.0)[:, :, None, None]
    aabb = torch.zeros((8, n_chunks), device=v0t.device)
    aabb[0:3] = torch.where(rej, 3e38, corners).amin((1, 2)).T
    aabb[3:6] = torch.where(rej, -3e38, corners).amax((1, 2)).T
    return aabb


def prep_triangles_packed(scene, alpha_test: bool = True, origin=None):
    """(tri_packed [n_chunks, TC, PACK_W], chunk AABBs [8, n_chunks]) for
    rays from `origin` (default: the scene camera position): per triangle
    nt, tp, bt, accept-back, ct, reject, alpha mask and three zeros."""
    if origin is None:
        origin = scene.camera.pos_w
    return pack_shared_origin(*prep_triangles(scene, alpha_test), origin)


def pack_shared_origin(v0t, e1t, e2t, flags, origin):
    """prep_triangles_packed's result from prep_triangles' arrays."""
    nt, bt, ct, tpk = shared_origin_rows(v0t, e1t, e2t, origin)
    packed = torch.cat([nt, tpk, bt, flags[0:1], ct, flags[1:3],
                        torch.zeros_like(nt)], 0)
    n_chunks = v0t.shape[1] // TC
    tri_packed = packed.reshape(PACK_W, n_chunks, TC).permute(1, 2, 0) \
        .contiguous()
    return tri_packed, chunk_aabbs(v0t, e1t, e2t, flags)



# ---------------------------------------------------------------------------
# the stochastic-depth key and decode
# ---------------------------------------------------------------------------

def _wrap32(x):
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def key15_of_hash(hb):
    """15-bit reservoir key of int32 hash values (as int64 tensors):
    floor mod 32767 of |hb|, where |INT_MIN| wraps to INT_MIN as in int32
    arithmetic (rt_pallas.py:76)."""
    return torch.remainder(_wrap32(torch.abs(hb)), 32767)


def sd_hash(u, v):
    """The int32 hash of the hit barycentrics (rt_pallas.py:73-75),
    evaluated in int64 with explicit 32-bit wrapping: wrapping multiply,
    arithmetic right shifts."""
    hb = _wrap32((u * 8388593.0).to(torch.int64)
                 ^ _wrap32((v * 4194301.0).to(torch.int64) << 7))
    hb = hb ^ (hb >> 8)
    hb = _wrap32(hb * 0x9E3779B1)
    return hb ^ (hb >> 13)


def decode_packed(packed, near, far, normalize: bool = True,
                  mode: str = "default"):
    """Packed int32 reservoir -> depths (normalized to [0, 1], 1.0 where
    empty; or linear view depth, far where empty)."""
    if mode == "coverage":
        d16 = packed
    else:
        d16 = packed // 32768 if mode == "kbuffer" else packed % 65536
    d = torch.where(packed == INVALID, 1.0,
                    true_div(d16.to(torch.float32), 65535.0))
    if normalize:
        return d
    return torch.where(packed == INVALID, far, d * (far - near) + near)


# ---------------------------------------------------------------------------
# the shadow-ray any-hit (K8): its pair test, the reference's trace
# ---------------------------------------------------------------------------


def any_hit_accepts(tri, ray):
    """K8's pair test: [n, R, TC] bool, does ray j of row i (ray [8, n, R]
    = ox, oy, oz, dx, dy, dz, tmin, tmax) hit triangle l of chunk tri[i]
    ([n, 12, TC] classic rows) in (tmin, tmax), alpha mask included? The
    kernel's float32 operations in its order (rt_pallas.py:
    _classic_origin_math with k = 1, back faces per their flag)."""
    tri = tri[:, :, None, :]                          # [n, 12, 1, TC]
    ox, oy, oz, dx, dy, dz, tmin, tmax = (r[:, :, None] for r in ray)
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tvx = ox - tri[:, 0]
    tvy = oy - tri[:, 1]
    tvz = oz - tri[:, 2]
    pu = tvx * px + tvy * py + tvz * pz
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    pv = dx * qx + dy * qy + dz * qz
    tp = e2x * qx + e2y * qy + e2z * qz
    ok = (torch.abs(det) > EPS_DET) \
        & ((det > 0.0) | (tri[:, 9] > 0.0))
    sg = torch.where(det >= 0.0, 1.0, -1.0)
    adet, spu, spv, stp = det * sg, pu * sg, pv * sg, tp * sg
    ok = ok & (tri[:, 10] == 0.0)
    ok_face = ok & (spu >= 0.0) & (spv >= 0.0) \
        & (spu + spv <= adet) & (stp > tmin * adet) \
        & (stp < tmax * adet)
    inv_det = 1.0 / torch.where(torch.abs(det) < EPS_DET, 1.0, det)
    # lanes that fail the face test are zeroed before the integer
    # conversion (their values are discarded anyway)
    u = torch.where(ok_face, pu * inv_det, 0.0)
    v = torch.where(ok_face, pv * inv_det, 0.0)
    cell = (torch.clamp(u * 4.0, 0.0, 3.0).to(torch.int32)
            + 4 * torch.clamp(v * 4.0, 0.0, 3.0).to(torch.int32))
    abit = torch.bitwise_right_shift(tri[:, 11].to(torch.int32),
                                     cell) & 1
    return ok_face & (abit > 0)


def any_hit(scene, origins, dirs, tmin, tmax):
    """Entry point (counterpart of any_hit_pallas): bool [R], some accepted
    triangle of `scene` lies on each ray in (tmin, tmax). Both faces block;
    alpha-masked triangles are tested against their baked 4x4 masks. Rays
    should come in 8x32-tile order (tile_flatten) so that a tile's segment
    box stays tight."""
    from .ref_any_hit import any_hit_reference
    return any_hit_reference(scene, origins, dirs, tmin, tmax)
