"""Stochastic-depth ray trace (K5 streamed, K7 resident): the wrappers of
csrc/sd_trace.cu, their plain PyTorch versions, and the tensor code around
them (counterpart of rtsdm_tpu/ops/rt_pallas.py, shared-origin tiers).

One ray per SD texel, all from the pinhole origin. Triangles are packed per
frame into [n_chunks, 128, 16] chunks of shared-origin rows, triangle-major
(the origin-dependent Möller-Trumbore cross products folded in once). K5
and K7 are one kernel: a block takes an 8x32 texel tile and walks, in
order, the chunks whose world AABB overlaps its segment bundle, listing
them itself. K5 takes rays in 8x32-tile order and also culls by the chunks'
pinhole screen footprint and distance range, with the reference's list
width (a tile with more overlaps walks every chunk); K7 reads the
row-major rays of an SD grid through the tile mapping and has no width.
Both insert hits in the reference's three modes (default/reservoir,
k-buffer, coverage) with an optional MaxCount cap.

The shadow-ray any-hit (K8, counterpart of rt_pallas.py:any_hit_pallas)
shares the chunking and the tile lists: its rays have their own origins, so
chunks hold raw [n_chunks, 12, 128] rows (v0, e1, e2, flags) and the tile
segment boxes are built from per-ray origins. Each ray also culls the
boxes of 32 triangles its own segment misses (any_hit_boxes).
"""
from __future__ import annotations

import torch

from .._build import launch, ptr, stream_of
from ..core.profiler import profile_scope
from ..utils.math import true_div
from ..utils.sampling import coverage_mask_select, coverage_table_tensors

RB = 256                  # rays (or pixels) per tile
TC = 128                  # triangles per chunk
TILE_RH, TILE_RW = 8, 32  # tile shape (TILE_RH * TILE_RW == RB)
LIST_CAP = 512            # chunk-list width once n_chunks > 2 * LIST_CAP
PACK_ROWS = 13            # nt(3) bt(3) ct(3) tp(1) + acc-back, reject, mask
PACK_W = 16               # floats a packed triangle: nt tp | bt acc | ct
                          # reject | mask + padding (csrc/sd_trace.cu)
# the shared-origin row (of rt_pallas.prep_triangles_packed's 13, in its
# order) at each of the first 13 places of a packed triangle; 13-15 are 0
PACK_ORDER = (0, 1, 2, 9, 3, 4, 5, 10, 6, 7, 8, 11, 12)
PACK_ROWS_CLASSIC = 12    # v0(3) e1(3) e2(3) + acc-back, reject, mask
INVALID = 2**31 - 1       # empty reservoir slot
EPS_DET = 1e-9
MODES = ("default", "kbuffer", "coverage")   # insertion modes, by kernel id
COVERAGE_MAX_K = 5        # the reference's coverage bound (rt_pallas.py:34)
COUNT_CAP = 2**30         # MaxCount's face-accepted counter saturates here


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


def list_width(n: int, cap: int = LIST_CAP) -> int:
    """The reference's list width for n chunks: `cap` when n > 2*cap, else
    n; a block with more overlaps than the width walks every chunk."""
    return cap if n > 2 * cap else n


def compact_lists(overlap, cap: int):
    """[nb, n] bool -> (lists [nb, width] int32: ascending overlapping
    column ids padded with 0, counts [nb] int32 unclamped), width =
    list_width(n, cap)."""
    n = overlap.shape[1]
    counts = overlap.sum(1, dtype=torch.int32)
    width = list_width(n, cap)
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


def tri_major(rows):
    """[n_chunks, PACK_ROWS, TC] shared-origin rows in the reference's
    order (rt_pallas.prep_triangles_packed) -> prep_triangles_packed's
    [n_chunks, TC, PACK_W]."""
    out = torch.zeros(rows.shape[0], TC, PACK_W, dtype=rows.dtype,
                      device=rows.device)
    out[:, :, :PACK_ROWS] = rows[:, list(PACK_ORDER)].transpose(1, 2)
    return out


def tri_rows(tri_packed):
    """prep_triangles_packed's chunks -> [n_chunks, PACK_ROWS, TC] rows in
    the reference's order (the inverse of tri_major)."""
    rows = torch.empty(tri_packed.shape[0], PACK_ROWS, TC,
                       dtype=tri_packed.dtype, device=tri_packed.device)
    rows[:, list(PACK_ORDER)] = tri_packed[:, :, :PACK_ROWS].transpose(1, 2)
    return rows


def pack_for_stream_classic(v0t, e1t, e2t, flags):
    """Raw-row chunks for rays with their own origins (any-hit):
    (tri_packed [n_chunks, PACK_ROWS_CLASSIC, TC], chunk AABBs [8, n])."""
    n_chunks = v0t.shape[1] // TC
    packed = torch.cat([v0t, e1t, e2t, flags], 0)
    tri_packed = packed.reshape(PACK_ROWS_CLASSIC, n_chunks, TC) \
        .permute(1, 0, 2).contiguous()
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


def build_chunk_lists(aabb, origin, dirs, tmin, tmax, rx=None, ry=None,
                      cap: int = LIST_CAP):
    """Per-ray-tile ascending lists of chunks that overlap the tile's
    segment bundle (world AABB test, plus the screen rows 6-11 of `aabb`
    when rx/ry — the rays' signed SD-texel coordinates — are given).
    `origin` is the rays' shared origin [3] or their own origins [R, 3].
    Returns (lists [nb, width] int32, counts [nb] int32 unclamped), width =
    list_width(n_chunks, cap)."""
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
        o = blk(origin[:, c]) if origin.dim() == 2 else origin[c]
        a = o + d * tmin_b
        b = o + d * tmax_b
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
    return compact_lists(overlap, cap)


LIST_WINDOW = 1024        # chunks a K5/K7 block lists at once


def block_lists_replay(aabb, origin, rays, rx=None, ry=None,
                       cap: int = LIST_CAP):
    """The list step of K5 and K7 (csrc/sd_trace.cu) in PyTorch, for rays
    [7, nb*256] (and rx, ry [nb*256]) in 8x32-tile order from `origin` [3]:
    each block's box reduced as the kernel reduces it (fmin/fmax over its
    rays, which skip NaN as fminf does), its overlaps counted over all
    chunks, and the overlapping ids listed in ascending order, LIST_WINDOW
    chunks at a time.
    Returns (lists [nb, width], counts [nb]) with width = list_width(n,
    cap): a block's ids, then zeros; a block with more overlaps than the
    width lists none (it walks every chunk)."""
    n = aabb.shape[1]
    nb = rays.shape[1] // RB
    r = rays.reshape(7, nb, RB)
    valid = r[4] > r[3]
    inf = torch.tensor(float("inf"), device=rays.device)

    def lo_hi(a, b):
        lo = torch.where(valid, torch.fmin(a, b), inf)
        hi = torch.where(valid, torch.fmax(a, b), -inf)
        return lo.amin(1)[:, None], hi.amax(1)[:, None]

    overlap = torch.ones((nb, n), dtype=torch.bool, device=rays.device)
    for c in range(3):
        lo, hi = lo_hi(origin[c] + r[c] * r[3], origin[c] + r[c] * r[4])
        overlap &= (aabb[c][None] <= hi) & (aabb[3 + c][None] >= lo)
    if rx is not None:
        for row, a, b in ((6, rx, rx), (7, ry, ry), (8, r[3], r[4])):
            a = a.reshape(r.shape[1:]) if a.dim() == 1 else a
            b = b.reshape(r.shape[1:]) if b.dim() == 1 else b
            lo, hi = lo_hi(a, b)
            overlap &= (aabb[row][None] <= hi) & (aabb[row + 3][None] >= lo)
    counts = overlap.sum(1, dtype=torch.int32)
    width = list_width(n, cap)
    lists = torch.zeros((nb, width), dtype=torch.int32, device=rays.device)
    for b in range(nb):
        if int(counts[b]) > width:
            continue
        ids = [torch.nonzero(overlap[b, w:w + LIST_WINDOW]).squeeze(1) + w
               for w in range(0, n, LIST_WINDOW)]
        ids = torch.cat(ids) if ids else lists.new_zeros(0)
        lists[b, :ids.numel()] = ids.to(torch.int32)
    return lists, counts


# ---------------------------------------------------------------------------
# the streamed trace (K5)
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
    with profile_scope("kernel.sd_keys"):
        if u.is_cuda:
            key_uv = torch.empty(u.shape, dtype=torch.int32, device=u.device)
            key_hb = torch.empty_like(key_uv)
            launch("rtsdm_sd_keys", ptr(u), ptr(v), ptr(hb), u.numel(),
                   ptr(key_uv), ptr(key_hb), stream_of(u))
            return key_uv, key_hb
        return (key15_of_hash(sd_hash(u, v)).to(torch.int32),
                key15_of_hash(hb.to(torch.int64)).to(torch.int32))


def _check_trace_args(fn, tri_packed, aabb, origin, rays, k, mode,
                      aabb_rows: int):
    for t, name in ((tri_packed, "tri_packed"), (aabb, "aabb"),
                    (origin, "origin"), (rays, "rays")):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32")
    if tri_packed.shape[1:] != (TC, PACK_W) or rays.dim() != 2 \
            or rays.shape[0] != 7 or rays.shape[1] % RB \
            or aabb.dim() != 2 or aabb.shape[0] < aabb_rows \
            or aabb.shape[1] != tri_packed.shape[0] or origin.shape != (3,):
        raise ValueError(f"{fn}: inconsistent shapes")
    if tri_packed.data_ptr() % 16:
        raise ValueError(f"{fn}: tri_packed must start on a 16-byte "
                         "boundary (the kernel copies it as float4)")
    if not 1 <= k <= 8 or mode not in MODES:
        raise ValueError(f"{fn}: unsupported k={k} mode={mode}")


def _tail_args(k: int, cull_back: bool, mode: str, max_count: int,
               alpha: float, device):
    """The insertion arguments K5 and K7 share: cull flag, mode id, cap,
    alpha * k (rounded to float32 by ctypes, as the jnp weak scalar
    rounds), and the coverage tables."""
    lut, idx = coverage_table_tensors(k, device)
    return (int(cull_back), MODES.index(mode), int(max_count), alpha * k,
            ptr(lut), lut.numel(), ptr(idx))


def sd_trace_blocks(tri_packed, aabb, origin, rays, k: int,
                    cull_back: bool = True, mode: str = "default",
                    max_count: int = 0, alpha: float = 0.2, rx=None,
                    ry=None):
    """K5: packed int32 slots [nb*256, k] (INVALID = empty) for rays
    [7, nb*256] = (dx, dy, dz, tmin, tmax, za, zb) from `origin` [3] in
    8x32-tile order, where depth_norm = clip(t*za - zb, 0, 1). Each tile
    walks, in order, the chunks whose AABB (aabb rows 0-5: min, max)
    overlaps its segment bundle and, given rx and ry [nb*256] (the rays'
    signed SD-texel coordinates), whose screen rows (aabb rows 6-11,
    chunk_screen_rows) overlap its texels: the lists of build_chunk_lists,
    built inside the kernel, with their width (list_width); a tile with
    more overlaps walks every chunk. Default and kbuffer slots ascend;
    coverage slots are per-slot minima of depth16. max_count > 0 caps the
    face-accepted hits that take part (MaxCount); alpha is the coverage
    insertion's."""
    with profile_scope("kernel.sd_trace_blocks"):
        fn = "sd_trace_blocks"
        _check_trace_args(fn, tri_packed, aabb, origin, rays, k, mode,
                          6 if rx is None else 12)
        if (rx is None) != (ry is None):
            raise ValueError(f"{fn}: rx and ry go together")
        if rx is not None and any(
                t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != rays.shape[1:] for t in (rx, ry)):
            raise ValueError(f"{fn}: rx and ry must be contiguous float32 "
                             f"[{rays.shape[1]}]")
        if tri_packed.is_cuda:
            out = torch.empty((rays.shape[1], k), dtype=torch.int32,
                              device=tri_packed.device)
            n_chunks = tri_packed.shape[0]
            launch("rtsdm_sd_trace", ptr(tri_packed), ptr(aabb), ptr(origin),
                   ptr(rays), None if rx is None else ptr(rx),
                   None if ry is None else ptr(ry), rays.shape[1] // RB,
                   n_chunks, list_width(n_chunks), k,
                   *_tail_args(k, cull_back, mode, max_count, alpha,
                               tri_packed.device),
                   ptr(out), stream_of(tri_packed))
            return out
        if tri_packed.device.type != "cpu":
            raise RuntimeError(f"{fn}: unsupported device {tri_packed.device}")
        return sd_trace_blocks_plain(tri_packed, aabb, origin, rays, k,
                                     cull_back, mode, max_count, alpha, rx, ry)


def sd_trace_blocks_plain(tri_packed, aabb, origin, rays, k: int,
                          cull_back: bool = True, mode: str = "default",
                          max_count: int = 0, alpha: float = 0.2, rx=None,
                          ry=None):
    """Plain PyTorch version of K5: the tiles' lists by build_chunk_lists,
    walked by _trace_lists_plain."""
    lists, counts = build_chunk_lists(aabb, origin, rays[0:3].T, rays[3],
                                      rays[4], rx, ry)
    return _trace_lists_plain(tri_packed, lists, counts, rays, k, cull_back,
                              mode, max_count, alpha)


def _trace_lists_plain(tri_packed, lists, counts, rays, k: int,
                       cull_back: bool, mode: str, max_count: int,
                       alpha: float, batch: int = 256):
    """The plain trace of K5 and K7: all blocks advance through their chunk
    lists together (`batch` blocks at a time); each visit folds the chunk's
    accepted hits into the slots (the k smallest distinct values of slots
    + candidates, or per-slot minima for coverage) after the MaxCount cap
    (exclusive ordinal of face-accepted hits in chunk order)."""
    dev = tri_packed.device
    nb, list_w = lists.shape
    n_chunks = tri_packed.shape[0]
    full = counts > list_w
    cnt = torch.where(full, n_chunks, counts)
    ray = rays.reshape(7, nb, RB)
    slots = torch.full((nb, RB, k), INVALID, dtype=torch.int64, device=dev)
    count = torch.zeros((nb, RB), dtype=torch.int64, device=dev)
    for j in range(int(cnt.max()) if nb else 0):
        for s in range(0, nb, batch):
            sl = slice(s, min(s + batch, nb))
            act = cnt[sl] > j
            if not bool(act.any()):
                continue
            rows = torch.nonzero(act).squeeze(1) + s
            ci = torch.where(full[rows], j,
                             lists[rows, min(j, list_w - 1)]).long()
            # [na, 16, 1, TC]: rows nt(0-2) tp(3) bt(4-6) acc(7) ct(8-10)
            # reject(11) mask(12)
            tri = tri_packed[ci].transpose(1, 2)[:, :, None, :]
            dx, dy, dz, tmin, tmax, za, zb = (ray[i, rows][:, :, None]
                                              for i in range(7))
            det = dx * tri[:, 0] + dy * tri[:, 1] + dz * tri[:, 2]
            pu = dx * tri[:, 4] + dy * tri[:, 5] + dz * tri[:, 6]
            pv = dx * tri[:, 8] + dy * tri[:, 9] + dz * tri[:, 10]
            tp = tri[:, 3].expand_as(det)
            if cull_back:
                ok = det > EPS_DET
                adet, spu, spv, stp = det, pu, pv, tp
            else:
                ok = (torch.abs(det) > EPS_DET) \
                    & ((det > 0.0) | (tri[:, 7] > 0.0))
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
            if max_count:
                okf = ok_face.to(torch.int64)
                ordinal = torch.cumsum(okf, -1) - okf   # exclusive
                okh = okh & (count[rows][..., None] + ordinal < max_count)
                count[rows] = torch.clamp(count[rows] + okf.sum(-1),
                                          max=COUNT_CAP)
            d_norm = torch.clamp(t * za - zb, 0.0, 1.0)
            d16 = torch.clamp((d_norm * 65535.0).to(torch.int64), 0, 65535)
            hb = sd_hash(u, v)
            k15 = key15_of_hash(hb)
            if mode == "coverage":
                rng = k15.to(torch.float32) * (1.0 / 32767.0)
                h2 = (hb ^ _wrap32(d16 * 0x9E3779B1)) ^ (hb >> 5)
                h2 = h2 ^ (h2 >> 11)
                rng2 = key15_of_hash(h2).to(torch.float32) * (1.0 / 32767.0)
                mask = coverage_mask_select(alpha, rng, rng2, k)
                pk = torch.where(okh, d16, INVALID)
                new = torch.stack(
                    [torch.where(((mask >> q) & 1) > 0, pk, INVALID).amin(-1)
                     for q in range(k)], -1)
                slots[rows] = torch.minimum(slots[rows], new)
                continue
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


def _ray_rows(dirs, tmin, tmax, vz_scale, near, far):
    """K5's and K7's rays [7, nb*256] = (dx, dy, dz, tmin, tmax, za, zb)
    from [R, 3] directions and [R] intervals and view-depth scales; the
    padding rays are dead (tmax = -1)."""
    r = dirs.shape[0]
    rp = r + (-r) % RB
    inv_range = 1.0 / (far - near)
    za = vz_scale * inv_range
    zb = (near * inv_range).expand(r)

    def col(a, fill=0.0):
        return torch.nn.functional.pad(a, (0, rp - r), value=fill)

    return torch.stack([col(dirs[:, 0]), col(dirs[:, 1]), col(dirs[:, 2]),
                        col(tmin), col(tmax, fill=-1.0), col(za),
                        col(zb)]).contiguous()


def sd_trace_stream(tri_packed, aabb, origin, dirs, tmin, tmax, vz_scale,
                    near, far, *, num_samples: int = 4,
                    cull_back: bool = True, mode: str = "default",
                    max_count: int = 0, alpha: float = 0.2, rx=None,
                    ry=None):
    """Streamed tier (counterpart of sd_trace_pallas_stream): dirs [R,3],
    tmin/tmax/vz_scale [R] and the signed texel coordinates rx/ry [R] (or
    None: no screen cull) in 8x32-tile order; returns the packed slots
    [R, num_samples] int32 (K5, which lists each tile's chunks itself)."""
    rays = _ray_rows(dirs, tmin, tmax, vz_scale, near, far)
    if rx is not None:
        pad = rays.shape[1] - rx.shape[0]
        rx, ry = (torch.nn.functional.pad(a, (0, pad)).contiguous()
                  for a in (rx, ry))
    return sd_trace_blocks(tri_packed, aabb.contiguous(),
                           origin.contiguous(), rays, num_samples, cull_back,
                           mode, max_count, alpha, rx, ry)[:dirs.shape[0]]


# ---------------------------------------------------------------------------
# the resident trace (K7)
# ---------------------------------------------------------------------------

def _grid(rays, grid):
    """(h, w) of the SD grid whose row-major rays `rays` holds; without a
    grid, 32 wide, so that a tile is 256 consecutive rays."""
    h, w = grid if grid is not None else (rays.shape[1] // TILE_RW, TILE_RW)
    if h < 0 or w < 0 or h * w > rays.shape[1]:
        raise ValueError(f"grid {h}x{w} does not fit {rays.shape[1]} rays")
    return int(h), int(w)


def sd_trace_resident_blocks(tri_packed, aabb, origin, rays, k: int,
                             cull_back: bool = True, mode: str = "default",
                             max_count: int = 0, alpha: float = 0.2,
                             grid=None):
    """K7: K5's function for rays [7, n] in row-major order over an SD grid
    `grid` = (h, w) (h * w <= n; default (n / 32, 32)); returns [h * w, k].
    A block takes an 8x32 tile of the grid and walks, in order, every chunk
    whose AABB (aabb [6, n_chunks], rows 0-2 min, 3-5 max) overlaps the box
    of its valid segments from `origin` [3], listing them itself; there is
    no list width."""
    with profile_scope("kernel.sd_trace_resident_blocks"):
        fn = "sd_trace_resident_blocks"
        _check_trace_args(fn, tri_packed, aabb, origin, rays, k, mode, 6)
        if aabb.shape[0] != 6:
            raise ValueError(f"{fn}: aabb [6, n_chunks]")
        h, w = _grid(rays, grid)
        if tri_packed.is_cuda:
            out = torch.empty((h * w, k), dtype=torch.int32,
                              device=tri_packed.device)
            launch("rtsdm_sd_trace_resident", ptr(tri_packed), ptr(aabb),
                   ptr(origin), ptr(rays), rays.shape[1], h, w,
                   tri_packed.shape[0], k,
                   *_tail_args(k, cull_back, mode, max_count, alpha,
                               tri_packed.device),
                   ptr(out), stream_of(tri_packed))
            return out
        if tri_packed.device.type != "cpu":
            raise RuntimeError(f"{fn}: unsupported device {tri_packed.device}")
        return sd_trace_resident_blocks_plain(tri_packed, aabb, origin, rays,
                                              k, cull_back, mode, max_count,
                                              alpha, grid)


def grid_tile_rays(rays, h: int, w: int):
    """Row-major rays [7, >= h*w] of an h x w grid -> [7, nt*256] in
    8x32-tile order, the grid padded to whole tiles with dead rays (0, and
    tmax = -1)."""
    a, _ = pad_tile(rays[:, :h * w].T.reshape(h, w, 7))
    live = torch.zeros(a.shape[:2], dtype=torch.bool, device=a.device)
    live[:h, :w] = True
    a = torch.cat([a[..., :4], torch.where(live, a[..., 4], -1.0)[..., None],
                   a[..., 5:]], -1)
    return tile_flatten(a).T.contiguous()


def sd_trace_resident_blocks_plain(tri_packed, aabb, origin, rays, k: int,
                                   cull_back: bool = True,
                                   mode: str = "default", max_count: int = 0,
                                   alpha: float = 0.2, grid=None):
    """Plain PyTorch version of K7: the grid's 8x32 tiles (grid_tile_rays),
    each with the ascending list of the chunks that overlap its segment box
    (build_chunk_lists' world test, with no width), walked as K5's plain
    version walks its lists."""
    h, w = _grid(rays, grid)
    tiled = grid_tile_rays(rays, h, w)
    lists, counts = build_chunk_lists(aabb, origin, tiled[0:3].T, tiled[3],
                                      tiled[4], cap=tri_packed.shape[0])
    out = _trace_lists_plain(tri_packed, lists, counts, tiled, k, cull_back,
                             mode, max_count, alpha)
    ph, pw = h + (-h) % TILE_RH, w + (-w) % TILE_RW
    return tile_unflatten(out, ph, pw)[:h, :w].reshape(h * w, k)


def sd_trace_resident(tri_packed, aabb, origin, dirs, tmin, tmax, vz_scale,
                      near, far, *, num_samples: int = 4,
                      cull_back: bool = True, mode: str = "default",
                      max_count: int = 0, alpha: float = 0.2, grid=None):
    """Resident tier (counterpart of sd_trace_pallas): dirs [R,3], tmin/
    tmax/vz_scale [R] in row-major order over the SD grid `grid` = (h, w)
    (h * w == R; without one, any order, in tiles of 256 consecutive
    rays); returns the packed slots [R, num_samples] int32 (K7)."""
    rays = _ray_rows(dirs, tmin, tmax, vz_scale, near, far)
    return sd_trace_resident_blocks(
        tri_packed, aabb[:6].contiguous(), origin.contiguous(), rays,
        num_samples, cull_back, mode, max_count, alpha,
        grid)[:dirs.shape[0]]


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
# the shadow-ray any-hit (K8)
# ---------------------------------------------------------------------------

CULL_SUB = 32             # triangles per cull box: a chunk has TC // CULL_SUB
N_CULL = TC // CULL_SUB
BOX_BIG = 3e38            # finite stand-in for infinity in the cull boxes
FLAT_DIR = 1e-30          # |d_c| below this: the segment is flat along c
U32 = 2.0 ** -24          # float32 unit roundoff
GAMMA8 = 8 * U32 / (1 - 8 * U32)   # gamma_8 = 8u / (1 - 8u)


def any_hit_boxes(tri_packed, rays):
    """K8's cull boxes [n_chunks, 6, N_CULL] float32 (rows: lo x, y, z, hi
    x, y, z; one box per CULL_SUB consecutive triangles of a chunk) for the
    live rays of `rays` [8, nb*256] against classic chunks [n_chunks, 12,
    TC]. A ray whose segment [tmin, tmax] misses a box (K8's slab test,
    segment_overlaps) cannot have any triangle of the box accepted by K8's
    float32 Moller-Trumbore test. The bound, for one accepted pair, with
    u = 2^-24 and G = gamma_8 (every gamma_k below is at most G):

    * the computed det', u*det' (pu'), v*det' (pv') and t*det' (tp') each
      lie within G * S * |tv|_1 / |d|_1 (det: G * S) of the exact triple
      products of the float inputs, S = |d|_1 |e1|_1 |e2|_1 (a cross
      product, then a dot product, no contraction);
    * the identity det*tv + tp*d = pu*e1 + pv*e2, exact for the exact
      products, then places P = o + t'd (t' = tp'/det' within [tmin,
      tmax] up to a factor 1 +- u) within delta = kappa * |tv|_1 of
      Q = v0 + u'e1 + v'e2 (u', v' >= 0, u' + v' <= 1 + u: in the
      triangle scaled by 1 + u about v0), per component, where kappa =
      (4 G S / |det'| + G)(1 + G);
    * |tv|_1 <= T |d|_1 + 3 delta + (1 + u) E (T = the largest |tmin|,
      |tmax|, E = the larger of |e1|_1, |e2|_1), so delta <= kappa (T
      |d|_1 + (1 + G) E) / (1 - 3 kappa) while 3 kappa < 1/2; beyond that
      the triangle gets the whole space and is never culled;
    * |det'| >= max(1e-9 (K8 accepts no smaller), |DET| - G S), and
      |DET| >= |d|_2 |n|_2 sin(psi - beta): n = e1 x e2, psi the angle
      between the rays' mean direction and the triangle's plane, beta the
      largest angle between a live ray and that mean (all computed in
      float64 for every live ray at once; a directional light gives beta
      ~ 0, so grazing triangles alone widen).

    Each triangle's box then grows by delta, by u T |d|_inf (t' beyond the
    interval), by gamma_8 (|face| + max |o|) (the slab test's three
    roundings move a face by at most gamma_3 |face - o|) and by 1e-20
    (flat axes, FLAT_DIR), and is rounded outward to float32. Rejected
    triangles (padding) extend no box; a box of none stays at (BOX_BIG,)*6,
    which no segment with tmax < 3e38 meets."""
    dev = tri_packed.device
    n_chunks = tri_packed.shape[0]
    empty = torch.full((n_chunks, 6, N_CULL), BOX_BIG, dtype=torch.float32,
                       device=dev)
    r = rays[:, rays[7] > rays[6]].double()          # the live rays
    if n_chunks == 0 or r.shape[1] == 0:
        return empty
    o, d, tmin, tmax = r[0:3], r[3:6], r[6], r[7]
    d1 = d.abs().sum(0).amax()
    dinf = d.abs().amax()
    big_t = torch.maximum(tmin.abs(), tmax.abs()).amax()
    wo = o.abs().amax()
    dn = d.norm(dim=0)
    dh = d / dn
    axis = dh.mean(1)
    axis = axis / axis.norm().clamp(min=1e-300)
    beta = torch.acos((dh * axis[:, None]).sum(0).amin().clamp(-1.0, 1.0)) \
        + 1e-6
    t = tri_packed.double()
    v0, e1, e2 = t[:, 0:3], t[:, 3:6], t[:, 6:9]            # [n, 3, TC]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
    nn = n.norm(dim=1)
    sin_psi = ((n * axis[None, :, None]).sum(1).abs()
               / nn.clamp(min=1e-300)).clamp(0.0, 1.0)
    ang = (torch.asin(sin_psi) - beta).clamp(min=0.0)
    det_lo = dn.amin() * nn * torch.sin(ang) * (1.0 - 1e-9)
    e1n, e2n = e1.abs().sum(1), e2.abs().sum(1)
    s = d1 * e1n * e2n
    adet = (det_lo - GAMMA8 * s).clamp(min=0.99e-9)
    kappa = (4.0 * GAMMA8 * s / adet + GAMMA8) * (1.0 + GAMMA8)
    delta = kappa * (big_t * d1 + (1.0 + GAMMA8) * torch.maximum(e1n, e2n)) \
        / (1.0 - 3.0 * kappa)
    bounded = (3.0 * kappa <= 0.5) & torch.isfinite(delta)
    zero = torch.zeros_like(e1)
    lo = v0 + (1.0 + U32) * torch.minimum(zero, torch.minimum(e1, e2))
    hi = v0 + (1.0 + U32) * torch.maximum(zero, torch.maximum(e1, e2))
    # float64 rounding of the corners, generously
    lo = lo - 1e-15 * (v0.abs() + e1.abs() + e2.abs())
    hi = hi + 1e-15 * (v0.abs() + e1.abs() + e2.abs())
    pad = (delta + U32 * big_t * dinf * (1.0 + GAMMA8))[:, None] + 1e-20
    lo = lo - pad
    hi = hi + pad
    lo = lo - GAMMA8 * (1.0 + GAMMA8) * (lo.abs() + wo)
    hi = hi + GAMMA8 * (1.0 + GAMMA8) * (hi.abs() + wo)
    lo = torch.where(bounded[:, None], lo, -BOX_BIG)
    hi = torch.where(bounded[:, None], hi, BOX_BIG)
    rej = (tri_packed[:, 10] != 0.0)[:, None]                # [n, 1, TC]
    lo = torch.where(rej, BOX_BIG, lo).reshape(n_chunks, 3, N_CULL,
                                               CULL_SUB).amin(-1)
    hi = torch.where(rej, -BOX_BIG, hi).reshape(n_chunks, 3, N_CULL,
                                                CULL_SUB).amax(-1)
    none = lo[:, :1] > 1e38                       # every triangle rejected
    hi = torch.where(none, BOX_BIG, hi)
    lo32 = lo.clamp(-BOX_BIG, BOX_BIG).float()
    hi32 = hi.clamp(-BOX_BIG, BOX_BIG).float()
    lo32 = torch.where(lo32.double() > lo, torch.nextafter(
        lo32, torch.tensor(-float("inf"), device=dev)), lo32)
    hi32 = torch.where(hi32.double() < hi, torch.nextafter(
        hi32, torch.tensor(float("inf"), device=dev)), hi32)
    return torch.cat([lo32, hi32], 1).contiguous()


def no_cull_boxes(n_chunks: int, device):
    """Cull boxes that cull nothing (every box the whole space): K8 then
    tests every triangle of every chunk it walks."""
    return torch.cat([torch.full((n_chunks, 3, N_CULL), -BOX_BIG,
                                 device=device),
                      torch.full((n_chunks, 3, N_CULL), BOX_BIG,
                                 device=device)], 1)


def slab_rows(rays):
    """Per ray, what K8's slab test reads: origin [3, R], 1/d [3, R] (0
    on a flat axis, |d_c| < FLAT_DIR), flat [3, R] bool, tmin, tmax [R]."""
    d = rays[3:6]
    flat = d.abs() < FLAT_DIR
    inv = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, d))
    return rays[0:3], inv, flat, rays[6], rays[7]


def segment_overlaps(o, inv, flat, tmin, tmax, lo, hi):
    """K8's float32 slab test of segments against boxes (every argument
    broadcast together; o, inv, flat, lo, hi indexed by axis first): does
    [tmin, tmax] meet the box? The same operations in the same order as
    any_hit.cu, so the answers agree bit for bit; a flat axis tests the
    origin against the slab, so no 0 * inf arises."""
    inf = float("inf")
    tn, tf = tmin, tmax
    for c in range(3):
        t0 = (lo[c] - o[c]) * inv[c]
        t1 = (hi[c] - o[c]) * inv[c]
        inside = (o[c] >= lo[c]) & (o[c] <= hi[c])
        a = torch.where(flat[c], torch.where(inside, -inf, inf),
                        torch.minimum(t0, t1))
        b = torch.where(flat[c], inf, torch.maximum(t0, t1))
        tn = torch.maximum(tn, a)
        tf = torch.minimum(tf, b)
    return tn <= tf


def _check_any_hit_args(tri_packed, boxes, lists, counts, rays):
    for t, dt, name in ((tri_packed, torch.float32, "tri_packed"),
                        (boxes, torch.float32, "boxes"),
                        (lists, torch.int32, "lists"),
                        (counts, torch.int32, "counts"),
                        (rays, torch.float32, "rays")):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"any_hit_blocks: {name} must be contiguous "
                             f"{dt}")
    nb = counts.shape[0]
    if tri_packed.shape[1:] != (PACK_ROWS_CLASSIC, TC) \
            or boxes.shape != (tri_packed.shape[0], 6, N_CULL) \
            or lists.shape[0] != nb or rays.shape != (8, nb * RB):
        raise ValueError("any_hit_blocks: inconsistent shapes")


def any_hit_blocks(tri_packed, boxes, lists, counts, rays):
    """K8: (hit [nb*256] bool, pairs [nb*256] int32) for rays [8, nb*256]
    = (ox, oy, oz, dx, dy, dz, tmin, tmax) in 8x32-tile order against
    classic chunks and their cull boxes (any_hit_boxes). Each ray walks its
    tile's list and tests the triangles of each box its segment meets, in
    order, until its first hit; pairs counts the ray-triangle pairs it
    tested, up to and including the one that hit. The hits are those of
    the walk without the cull (any_hit_blocks_plain with boxes None)."""
    with profile_scope("kernel.any_hit_blocks"):
        _check_any_hit_args(tri_packed, boxes, lists, counts, rays)
        if tri_packed.is_cuda:
            nb = counts.shape[0]
            hit = torch.empty((nb * RB,), dtype=torch.uint8,
                              device=tri_packed.device)
            pairs = torch.empty((nb * RB,), dtype=torch.int32,
                                device=tri_packed.device)
            launch("rtsdm_any_hit", ptr(tri_packed), ptr(boxes), ptr(lists),
                   ptr(counts), ptr(rays), nb, tri_packed.shape[0],
                   lists.shape[1], ptr(hit), ptr(pairs), stream_of(tri_packed))
            return hit.bool(), pairs
        if tri_packed.device.type != "cpu":
            raise RuntimeError(f"any_hit_blocks: unsupported device "
                               f"{tri_packed.device}")
        return any_hit_blocks_plain(tri_packed, boxes, lists, counts, rays)


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


# tiles of K8's plain version evaluated at once
ANY_HIT_PLAIN_BATCH = 64


def any_hit_blocks_plain(tri_packed, boxes, lists, counts, rays):
    """Plain PyTorch version of K8: tiles advance through their chunk
    lists together (ANY_HIT_PLAIN_BATCH tiles at a time); a tile stops once
    every live ray in it has hit. With boxes None every ray tests every
    triangle of every chunk it walks (the contract K8's hits are held to);
    with K8's boxes it replays K8's cull, so the pairs agree too."""
    dev = tri_packed.device
    nb, list_w = lists.shape
    n_chunks = tri_packed.shape[0]
    full = counts > list_w
    cnt = torch.where(full, n_chunks, counts)
    ray = rays.reshape(8, nb, RB)
    o, inv, flat, _, _ = (a.reshape(a.shape[:-1] + (nb, RB))
                          for a in slab_rows(rays))
    live = ray[7] > ray[6]
    hit = torch.zeros((nb, RB), dtype=torch.bool, device=dev)
    pairs = torch.zeros((nb, RB), dtype=torch.int32, device=dev)
    for j in range(int(cnt.max()) if nb else 0):
        act = (cnt > j) & (live & ~hit).any(1)
        if not bool(act.any()):
            break
        act_rows = torch.nonzero(act).squeeze(1)
        for s in range(0, act_rows.shape[0], ANY_HIT_PLAIN_BATCH):
            rows = act_rows[s:s + ANY_HIT_PLAIN_BATCH]
            ci = torch.where(full[rows], j,
                             lists[rows, min(j, list_w - 1)]).long()
            okh = any_hit_accepts(tri_packed[ci], ray[:, rows])
            if boxes is None:
                meets = torch.ones(okh.shape[:2] + (N_CULL,),
                                   dtype=torch.bool, device=dev)
            else:
                bx = boxes[ci][:, :, None, :]             # [na, 6, 1, N]
                meets = segment_overlaps(
                    *(a[:, rows, :, None] for a in (o, inv, flat)),
                    ray[6, rows][..., None], ray[7, rows][..., None],
                    bx[:, 0:3].unbind(1), bx[:, 3:6].unbind(1))
            okh = (okh.reshape(okh.shape[:2] + (N_CULL, CULL_SUB))
                   & meets[..., None]).reshape(okh.shape)
            # a ray tests, in order, the triangles of each box it meets up
            # to its first hit
            tested = live[rows] & ~hit[rows]
            got = okh.any(-1)
            first = torch.argmax(okh.to(torch.int32), -1)
            sub = meets.to(torch.int32) * CULL_SUB
            before = torch.cumsum(sub, -1) - sub
            upto = torch.gather(before, -1, (first // CULL_SUB)[..., None]
                                )[..., 0] + first % CULL_SUB + 1
            pairs[rows] += torch.where(
                tested, torch.where(got, upto, sub.sum(-1)), 0) \
                .to(torch.int32)
            hit[rows] |= tested & got
    return hit.reshape(nb * RB), pairs.reshape(nb * RB)


def any_hit_rays(origins, dirs, tmin, tmax):
    """Rays [8, nb*256] for K8 from [R, 3] origins and directions and [R]
    intervals (already in 8x32-tile order); padding rays are dead."""
    r = dirs.shape[0]
    rp = r + (-r) % RB

    def col(a, fill=0.0):
        return torch.nn.functional.pad(a, (0, rp - r), value=fill)

    return torch.stack([col(origins[:, 0]), col(origins[:, 1]),
                        col(origins[:, 2]), col(dirs[:, 0]), col(dirs[:, 1]),
                        col(dirs[:, 2]), col(tmin),
                        col(tmax, fill=-1.0)]).contiguous()


def any_hit_inputs(scene, origins, dirs, tmin, tmax):
    """K8's arguments (tri_packed, boxes, lists, counts, rays) for rays
    [R, 3] / [R] against `scene`: classic chunks with every face accepted
    (back faces block shadow rays; the scene builder's morton order keeps
    each chunk's triangles together), ordered near to far along the mean
    ray direction so tiles reach their occluders early, their cull boxes
    for these rays, and the tiles' lists."""
    with profile_scope("geometry.any_hit_inputs"):
        v0t, e1t, e2t, flags = prep_triangles(scene, True)
        flags = flags.clone()
        flags[0] = 1.0
        tri_packed, aabb = pack_for_stream_classic(v0t, e1t, e2t, flags)
        md = dirs.mean(0)
        cent = (aabb[0:3] + aabb[3:6]) * 0.5
        order = torch.argsort(cent[0] * md[0] + cent[1] * md[1]
                              + cent[2] * md[2], stable=True)
        tri_packed = tri_packed[order].contiguous()
        lists, counts = build_chunk_lists(aabb[:, order], origins, dirs, tmin,
                                          tmax)
        rays = any_hit_rays(origins, dirs, tmin, tmax)
        return (tri_packed, any_hit_boxes(tri_packed, rays), lists, counts,
                rays)


def any_hit(scene, origins, dirs, tmin, tmax):
    """Entry point (counterpart of any_hit_pallas): bool [R], some accepted
    triangle of `scene` lies on each ray in (tmin, tmax). Both faces block;
    alpha-masked triangles are tested against their baked 4x4 masks. Rays
    should come in 8x32-tile order (tile_flatten) so that a tile's segment
    box stays tight."""
    hit, _ = any_hit_blocks(*any_hit_inputs(scene, origins, dirs, tmin,
                                            tmax))
    return hit[:dirs.shape[0]]
