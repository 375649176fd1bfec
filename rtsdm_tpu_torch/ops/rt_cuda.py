"""Stochastic-depth ray trace (K5): the wrapper of csrc/sd_trace.cu, its
plain PyTorch version, and the tensor code around it (counterpart of
rtsdm_tpu/ops/rt_pallas.py, streaming shared-origin tier).

One ray per SD texel, all from the pinhole origin. Triangles are packed per
frame into [n_chunks, 13, 128] chunks of shared-origin rows (the
origin-dependent Möller-Trumbore cross products folded in once); each 8x32
ray tile gets the ascending list of chunks whose world AABB overlaps its
segment bundle and whose pinhole screen footprint and distance range
overlap its texels. Only the default/reservoir and k-buffer insertions are
ported; coverage and MaxCount stay with the reference (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from .._build import launch, ptr, stream_of
from ..utils.math import true_div

RB = 256                  # rays (or pixels) per tile
TC = 128                  # triangles per chunk
TILE_RH, TILE_RW = 8, 32  # tile shape (TILE_RH * TILE_RW == RB)
LIST_CAP = 512            # chunk-list width once n_chunks > 2 * LIST_CAP
PACK_ROWS = 13            # nt(3) bt(3) ct(3) tp(1) + acc-back, reject, mask
INVALID = 2**31 - 1       # empty reservoir slot
EPS_DET = 1e-9
MODES = ("default", "kbuffer")


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


def compact_lists(overlap, cap: int):
    """[nb, n] bool -> (lists [nb, width] int32: ascending overlapping
    column ids padded with 0, counts [nb] int32 unclamped). width is `cap`
    when n > 2*cap, else n — the reference's list width rule; a block with
    more than `width` overlaps streams every chunk instead."""
    n = overlap.shape[1]
    counts = overlap.sum(1, dtype=torch.int32)
    width = cap if n > 2 * cap else n
    ids = torch.arange(n, dtype=torch.int32, device=overlap.device)
    keys = torch.where(overlap, ids, n)
    keys = torch.sort(keys, dim=1).values[:, :width]
    return torch.where(keys == n, 0, keys).contiguous(), counts


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
    """(tri_packed [n_chunks, PACK_ROWS, TC], chunk AABBs [8, n_chunks]) for
    rays from `origin` (default: the scene camera position)."""
    if origin is None:
        origin = scene.camera.pos_w
    v0t, e1t, e2t, flags = prep_triangles(scene, alpha_test)
    nt, bt, ct, tpk = shared_origin_rows(v0t, e1t, e2t, origin)
    packed = torch.cat([nt, bt, ct, tpk, flags], 0)
    n_chunks = v0t.shape[1] // TC
    tri_packed = packed.reshape(PACK_ROWS, n_chunks, TC).permute(1, 0, 2) \
        .contiguous()
    return tri_packed, chunk_aabbs(v0t, e1t, e2t, flags)


def chunk_screen_rows(aabb, origin, cam_u, cam_v, cam_w, dim_w: int,
                      dim_h: int):
    """Pinhole-fan cull rows [6, n_chunks]: (x0, y0, dmin, x1, y1, dmax) —
    the signed SD-texel rect a chunk AABB's projection can touch and its
    euclidean distance range from the shared origin. Conservative: the
    projection of a box attains its extrema at the corners (all corners in
    front; else the rect is infinite), a texel samples [p*dim - 1, p*dim],
    and the margins absorb rounding."""
    nc = aabb.shape[1]
    lo, hi = aabb[0:3], aabb[3:6]
    o = origin.reshape(3, 1)
    uu = (cam_u * cam_u).sum()
    vv = (cam_v * cam_v).sum()
    ww = (cam_w * cam_w).sum()
    inf = torch.full((nc,), float("inf"), device=aabb.device)
    px0, px1, py0, py1, wmin = inf, -inf, inf, -inf, inf
    for m in range(8):
        corner = torch.stack([hi[c] if (m >> c) & 1 else lo[c]
                              for c in range(3)])
        rel = corner - o
        a = (rel[0] * cam_u[0] + rel[1] * cam_u[1] + rel[2] * cam_u[2]) / uu
        b = (rel[0] * cam_v[0] + rel[1] * cam_v[1] + rel[2] * cam_v[2]) / vv
        w = (rel[0] * cam_w[0] + rel[1] * cam_w[1] + rel[2] * cam_w[2]) / ww
        wmin = torch.minimum(wmin, w)
        ws = torch.clamp(w, min=1e-12)
        sx = (a / ws + 1.0) * 0.5 * dim_w
        sy = (1.0 - b / ws) * 0.5 * dim_h
        px0, px1 = torch.minimum(px0, sx), torch.maximum(px1, sx)
        py0, py1 = torch.minimum(py0, sy), torch.maximum(py1, sy)
    big = 3e38
    front = wmin > 1e-9
    x0 = torch.where(front, px0 - 1.5, -big)
    x1 = torch.where(front, px1 + 0.5, big)
    y0 = torch.where(front, py0 - 1.5, -big)
    y1 = torch.where(front, py1 + 0.5, big)
    gap = torch.clamp(torch.maximum(lo - o, o - hi), min=0.0)
    dmin = torch.sqrt(gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2])
    far = torch.maximum(torch.abs(lo - o), torch.abs(hi - o))
    dmax = torch.sqrt(far[0] * far[0] + far[1] * far[1] + far[2] * far[2])
    dmin = dmin * (1.0 - 1e-5)
    dmax = dmax * (1.0 + 1e-5) + 1e-5
    empty = aabb[0] > 1e37        # chunks of padding only
    x0 = torch.where(empty, big, x0)
    x1 = torch.where(empty, -big, x1)
    return torch.stack([x0, y0, dmin, x1, y1, dmax])


def build_chunk_lists(aabb, origin, dirs, tmin, tmax, rx=None, ry=None):
    """Per-ray-tile ascending lists of chunks that overlap the tile's
    segment bundle (world AABB test, plus the screen rows 6-11 of `aabb`
    when rx/ry — the rays' signed SD-texel coordinates — are given).
    Returns (lists [nb, width] int32, counts [nb] int32 unclamped)."""
    r = dirs.shape[0]
    rp = r + (-r) % RB
    nb = rp // RB

    def blk(a, fill=0.0):
        return torch.nn.functional.pad(a, (0, rp - r), value=fill) \
            .reshape(nb, RB)

    tmin_b, tmax_b = blk(tmin), blk(tmax, fill=-1.0)
    valid = tmax_b > tmin_b
    inf = float("inf")
    overlap = torch.ones((nb, aabb.shape[1]), dtype=torch.bool,
                         device=dirs.device)
    for c in range(3):
        d = blk(dirs[:, c])
        a = origin[c] + d * tmin_b
        b = origin[c] + d * tmax_b
        lo = torch.where(valid, torch.minimum(a, b), inf).amin(1)
        hi = torch.where(valid, torch.maximum(a, b), -inf).amax(1)
        overlap &= (aabb[c][None, :] <= hi[:, None]) \
            & (aabb[3 + c][None, :] >= lo[:, None])
    if rx is not None and aabb.shape[0] >= 12:
        def rng(a):
            ab = blk(a)
            return (torch.where(valid, ab, inf).amin(1),
                    torch.where(valid, ab, -inf).amax(1))

        bx0, bx1 = rng(rx)
        by0, by1 = rng(ry)
        bt0 = torch.where(valid, tmin_b, inf).amin(1)
        bt1 = torch.where(valid, tmax_b, -inf).amax(1)
        overlap &= (aabb[6][None, :] <= bx1[:, None]) \
            & (aabb[9][None, :] >= bx0[:, None]) \
            & (aabb[7][None, :] <= by1[:, None]) \
            & (aabb[10][None, :] >= by0[:, None]) \
            & (aabb[8][None, :] <= bt1[:, None]) \
            & (aabb[11][None, :] >= bt0[:, None])
    return compact_lists(overlap, LIST_CAP)


# ---------------------------------------------------------------------------
# the trace (K5)
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


def sd_keys(u, v, hb):
    """(key15 of hash(u, v), key15 of hb) for float32 u, v and int32 hb of
    one shape — on CUDA tensors through the trace kernel's own device
    functions (a check of the integer semantics, not part of the trace)."""
    if u.is_cuda:
        key_uv = torch.empty(u.shape, dtype=torch.int32, device=u.device)
        key_hb = torch.empty_like(key_uv)
        launch("rtsdm_sd_keys", ptr(u), ptr(v), ptr(hb), u.numel(),
               ptr(key_uv), ptr(key_hb), stream_of(u))
        return key_uv, key_hb
    return (key15_of_hash(sd_hash(u, v)).to(torch.int32),
            key15_of_hash(hb.to(torch.int64)).to(torch.int32))


def _check_trace_args(tri_packed, lists, counts, rays, k, mode):
    for t, dt, name in ((tri_packed, torch.float32, "tri_packed"),
                        (lists, torch.int32, "lists"),
                        (counts, torch.int32, "counts"),
                        (rays, torch.float32, "rays")):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"sd_trace_blocks: {name} must be contiguous "
                             f"{dt}")
    nb = counts.shape[0]
    if tri_packed.shape[1:] != (PACK_ROWS, TC) or lists.shape[0] != nb \
            or rays.shape != (7, nb * RB):
        raise ValueError("sd_trace_blocks: inconsistent shapes")
    if not 1 <= k <= 8 or mode not in MODES:
        raise ValueError(f"sd_trace_blocks: unsupported k={k} mode={mode}")


def sd_trace_blocks(tri_packed, lists, counts, rays, k: int,
                    cull_back: bool = True, mode: str = "default"):
    """K5: packed int32 reservoir [nb*256, k] (ascending, INVALID = empty)
    for rays [7, nb*256] = (dx, dy, dz, tmin, tmax, za, zb) in 8x32-tile
    order, where depth_norm = clip(t*za - zb, 0, 1)."""
    _check_trace_args(tri_packed, lists, counts, rays, k, mode)
    if tri_packed.is_cuda:
        nb = counts.shape[0]
        out = torch.empty((nb * RB, k), dtype=torch.int32,
                          device=tri_packed.device)
        launch("rtsdm_sd_trace", ptr(tri_packed), ptr(lists), ptr(counts),
               ptr(rays), nb, tri_packed.shape[0], lists.shape[1], k,
               int(cull_back), int(mode == "kbuffer"), ptr(out),
               stream_of(tri_packed))
        return out
    if tri_packed.device.type != "cpu":
        raise RuntimeError(f"sd_trace_blocks: unsupported device "
                           f"{tri_packed.device}")
    return sd_trace_blocks_plain(tri_packed, lists, counts, rays, k,
                                 cull_back, mode)


def sd_trace_blocks_plain(tri_packed, lists, counts, rays, k: int,
                          cull_back: bool = True, mode: str = "default",
                          batch: int = 256):
    """Plain PyTorch version of K5: all tiles advance through their chunk
    lists together (`batch` tiles at a time); each visit folds the chunk's
    accepted hits into the reservoir as the k smallest distinct values of
    slots + candidates."""
    dev = tri_packed.device
    nb, list_w = lists.shape
    n_chunks = tri_packed.shape[0]
    full = counts > list_w
    cnt = torch.where(full, n_chunks, counts)
    ray = rays.reshape(7, nb, RB)
    slots = torch.full((nb, RB, k), INVALID, dtype=torch.int64, device=dev)
    for j in range(int(cnt.max()) if nb else 0):
        for s in range(0, nb, batch):
            sl = slice(s, min(s + batch, nb))
            act = cnt[sl] > j
            if not bool(act.any()):
                continue
            rows = torch.nonzero(act).squeeze(1) + s
            ci = torch.where(full[rows], j,
                             lists[rows, min(j, list_w - 1)]).long()
            tri = tri_packed[ci][:, :, None, :]               # [na,13,1,TC]
            dx, dy, dz, tmin, tmax, za, zb = (ray[i, rows][:, :, None]
                                              for i in range(7))
            det = dx * tri[:, 0] + dy * tri[:, 1] + dz * tri[:, 2]
            pu = dx * tri[:, 3] + dy * tri[:, 4] + dz * tri[:, 5]
            pv = dx * tri[:, 6] + dy * tri[:, 7] + dz * tri[:, 8]
            tp = tri[:, 9].expand_as(det)
            if cull_back:
                ok = det > EPS_DET
                adet, spu, spv, stp = det, pu, pv, tp
            else:
                ok = (torch.abs(det) > EPS_DET) \
                    & ((det > 0.0) | (tri[:, 10] > 0.0))
                sg = torch.where(det >= 0.0, 1.0, -1.0)
                adet, spu, spv, stp = det * sg, pu * sg, pv * sg, tp * sg
            ok = ok & (tri[:, 11] == 0.0)
            ok_face = ok & (spu >= 0.0) & (spv >= 0.0) \
                & (spu + spv <= adet) & (stp > tmin * adet) \
                & (stp < tmax * adet)
            inv = 1.0 / torch.where(torch.abs(det) < EPS_DET, 1.0, det)
            # lanes that fail the face test are zeroed before the integer
            # conversions (their values are discarded anyway)
            u = torch.where(ok_face, pu * inv, 0.0)
            v = torch.where(ok_face, pv * inv, 0.0)
            t = torch.where(ok_face, tp * inv, 0.0)
            cell = (torch.clamp(u * 4.0, 0.0, 3.0).to(torch.int32)
                    + 4 * torch.clamp(v * 4.0, 0.0, 3.0).to(torch.int32))
            amask = tri[:, 12].to(torch.int32)
            abit = torch.bitwise_right_shift(amask, cell) & 1
            okh = ok_face & (abit > 0)
            d_norm = torch.clamp(t * za - zb, 0.0, 1.0)
            d16 = torch.clamp((d_norm * 65535.0).to(torch.int64), 0, 65535)
            k15 = key15_of_hash(sd_hash(u, v))
            if mode == "kbuffer":
                packed = d16 * 32768 + torch.clamp(k15, max=32766)
            else:
                packed = k15 * 65536 + d16
            packed = torch.where(okh, packed, INVALID)
            both = torch.cat([slots[rows], packed], -1).sort(-1).values
            dup = torch.zeros_like(both, dtype=torch.bool)
            dup[..., 1:] = both[..., 1:] == both[..., :-1]
            both = torch.where(dup, INVALID, both).sort(-1).values
            slots[rows] = both[..., :k]
    return slots.reshape(nb * RB, k).to(torch.int32)


def sd_trace_stream(tri_packed, aabb, origin, dirs, tmin, tmax, vz_scale,
                    near, far, *, num_samples: int = 4,
                    cull_back: bool = True, mode: str = "default",
                    rx=None, ry=None):
    """Driver (counterpart of sd_trace_pallas_stream): dirs [R,3], tmin/
    tmax/vz_scale [R] in 8x32-tile order; returns the packed reservoir
    [R, num_samples] int32."""
    r = dirs.shape[0]
    rp = r + (-r) % RB
    lists, counts = build_chunk_lists(aabb, origin, dirs, tmin, tmax, rx, ry)
    inv_range = 1.0 / (far - near)
    za = vz_scale * inv_range
    zb = (near * inv_range).expand(r)

    def col(a, fill=0.0):
        return torch.nn.functional.pad(a, (0, rp - r), value=fill)

    rays = torch.stack([col(dirs[:, 0]), col(dirs[:, 1]), col(dirs[:, 2]),
                        col(tmin), col(tmax, fill=-1.0), col(za), col(zb)])
    return sd_trace_blocks(tri_packed, lists, counts, rays.contiguous(),
                           num_samples, cull_back, mode)[:r]


def decode_packed(packed, near, far, normalize: bool = True,
                  mode: str = "default"):
    """Packed int32 reservoir -> depths (normalized to [0, 1], 1.0 where
    empty; or linear view depth, far where empty)."""
    d16 = packed // 32768 if mode == "kbuffer" else packed % 65536
    d = torch.where(packed == INVALID, 1.0,
                    true_div(d16.to(torch.float32), 65535.0))
    if normalize:
        return d
    return torch.where(packed == INVALID, far, d * (far - near) + near)
