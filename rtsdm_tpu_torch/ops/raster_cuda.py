"""Sort-middle visibility raster (K1) and attribute fetch (K2), the wrappers
of csrc/raster.cu, and the k-slot stochastic-depth raster (K9), the wrapper
of csrc/raster_sd.cu: with their plain PyTorch versions and the tensor code
around them (counterpart of rtsdm_tpu/ops/raster_pallas.py).

Per frame: triangles are re-sorted by the screen-space morton code of their
bbox centre (so 128-triangle chunks are screen-compact), packed into
[n_chunks, 17, 128] coefficient chunks with each triangle's cull box beside
them ([n_chunks, 4, 128]), and every 8x32-pixel tile gets the ascending
list of chunks whose screen bbox overlaps it. K1 walks each tile's list and
culls a visited chunk's triangles by their boxes; K9 walks the same
lists. A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr, stream_of
from ..core.profiler import profile_scope
from ..utils.sampling import coverage_mask_select, coverage_table_tensors
from .rt_cuda import (LIST_CAP, RB, TC, TILE_RH, TILE_RW, _wrap32,
                      compact_lists, key15_of_hash, tile_flatten,
                      tile_unflatten)

COEF_ROWS = 17  # c0(3) c1(3) c2(3) zc(3) wc(3) valid(1) orig_id(1)
_BIG = 3e38


def screen_morton_order(bbox, valid, width: int, height: int):
    """Stable argsort of the 2-D morton code of each triangle's screen bbox
    centre; invalid triangles sort last, so trailing chunks are empty."""
    cx = torch.clamp((bbox[:, 0] + bbox[:, 2]) * (0.5 * 1024.0 / width),
                     0.0, 1023.0).to(torch.int32)
    cy = torch.clamp((bbox[:, 1] + bbox[:, 3]) * (0.5 * 1024.0 / height),
                     0.0, 1023.0).to(torch.int32)

    def spread(v):  # interleave 10 bits with zeros
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    key = spread(cx) | (spread(cy) << 1)
    key = torch.where(valid, key, 2**30)
    return torch.argsort(key, stable=True)


def pack_coef_chunks(coef, valid, orig_id):
    """[T,5,3] coefficients + [T] valid + [T] original ids ->
    [n_chunks, COEF_ROWS, TC] (padding triangles invalid). The original id
    rides as a float row, exact to 2^24."""
    t = coef.shape[0]
    tp = t + (-t) % TC
    rows = torch.cat([coef.reshape(t, 15), valid.to(torch.float32)[:, None],
                      orig_id.to(torch.float32)[:, None]], 1)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, tp - t))
    return rows.T.reshape(COEF_ROWS, tp // TC, TC).permute(1, 0, 2) \
        .contiguous()


def chunk_screen_bboxes(bbox, valid):
    """Per-chunk screen bbox [4, n_chunks] (x0, y0, x1, y1); invalid
    triangles do not extend it (an empty chunk overlaps nothing)."""
    t = bbox.shape[0]
    tp = t + (-t) % TC
    bb = torch.nn.functional.pad(bbox, (0, 0, 0, tp - t)).reshape(-1, TC, 4)
    va = torch.nn.functional.pad(valid, (0, tp - t)).reshape(-1, TC, 1)
    lo = torch.where(va, bb[..., 0:2], _BIG).amin(1)
    hi = torch.where(va, bb[..., 2:4], -_BIG).amax(1)
    return torch.cat([lo, hi], 1).T


def tile_rects(blk, nbx: int, rows: int = TILE_RH, part=0):
    """Pixel rectangles (x0, y0, x1, y1), float32, of 8x32 tiles `blk`:
    tile (by, bx) covers [bx*32, bx*32+32) x [by*8, by*8+8); with `rows` <
    8, the rows [by*8 + part*rows, ... + rows) of it."""
    bx = (blk % nbx).to(torch.float32) * TILE_RW
    by = (blk // nbx).to(torch.float32) * TILE_RH + part * rows
    return bx, by, bx + TILE_RW, by + rows


def build_chunk_lists_2d(cbox, nby: int, nbx: int):
    """Per-tile chunk lists in screen space: the ascending chunks whose
    box overlaps each tile's rectangle (strict comparisons)."""
    blk = torch.arange(nby * nbx, dtype=torch.int32, device=cbox.device)
    x0, y0, x1, y1 = tile_rects(blk, nbx)
    overlap = ((cbox[0][None, :] < x1[:, None])
               & (cbox[2][None, :] > x0[:, None])
               & (cbox[1][None, :] < y1[:, None])
               & (cbox[3][None, :] > y0[:, None]))
    return compact_lists(overlap, LIST_CAP)


# bounds of K1's float32 fragment test: its tolerance 1e-5f with the
# roundings of |e0| + |e1| + |e2| and of the product, and the rounding of an
# edge function (cx * px + cy * py) + cz, at most 3 ulp-halves of
# |cx px| + |cy py| + |cz| (gamma_3 = 3 * 2^-24 / (1 - 3 * 2^-24) < 1.8e-7)
CULL_TOL = 1.00001e-5
CULL_ROUND = 2e-7


def cull_boxes(coef, wp: int, hp: int):
    """Per-triangle boxes [T, 4] (x0, y0, x1, y1) enclosing every point of
    [0, wp] x [0, hp] at which K1's float32 fragment test can accept the
    triangle, from the edge functions it evaluates (coef [T, 5, 3] rows c0,
    c1, c2): there e_i >= -m_i, where m_i bounds the tolerance (by the
    largest |e_j| at a corner of the region) and the rounding of e_i. The
    three lines e_i = -m_i, computed in float64, bound a triangle when each
    vertex lies strictly inside the opposite line; its box, widened by a
    bound of the float64 and float32 roundings, is the cull box. A
    near-degenerate triangle (ill-conditioned or unbounded region: a sliver
    is accepted along its whole supporting line) gets the whole plane, so
    its tiles are never culled. The vertices' own boxes (_setup_triangles)
    do not bound such a triangle's accepted points; these do."""
    a, b, d = coef[:, :3].double().unbind(-1)      # [T, edge] each
    aw, bh = a * wp, b * hp
    corner = torch.stack([d, aw + d, bh + d, aw + bh + d]).abs().amax(0)
    err = CULL_ROUND * (aw.abs() + bh.abs() + d.abs())
    m = CULL_TOL * (corner.sum(-1, keepdim=True)
                    + err.sum(-1, keepdim=True)) + err
    d = d + m
    # vertex k: the lines k+1 (i) and k+2 (j)
    ai, bi, di = (t.roll(-1, 1) for t in (a, b, d))
    aj, bj, dj = (t.roll(-2, 1) for t in (a, b, d))
    det = ai * bj - aj * bi
    qx = (bi * dj - bj * di) / det
    qy = (aj * di - ai * dj) / det
    inner = a * qx + b * qy + d
    ok = ((det.abs() > 1e-6 * ((ai * bj).abs() + (aj * bi).abs()))
          & (inner > 1e-6 * ((a * qx).abs() + (b * qy).abs() + d.abs()))
          & torch.isfinite(qx) & torch.isfinite(qy)).all(-1)
    # the float64 roundings of q, generously, and float32's of the box
    ex = 1e-3 + 1e-12 * ((bi * dj).abs() + (bj * di).abs()) / det.abs() \
        + 1e-6 * qx.abs()
    ey = 1e-3 + 1e-12 * ((aj * di).abs() + (ai * dj).abs()) / det.abs() \
        + 1e-6 * qy.abs()
    lo = torch.stack([(qx - ex).amin(-1), (qy - ey).amin(-1)], -1)
    hi = torch.stack([(qx + ex).amax(-1), (qy + ey).amax(-1)], -1)
    lo = torch.where(ok[:, None], lo, -_BIG).clamp(min=-_BIG)
    hi = torch.where(ok[:, None], hi, _BIG).clamp(max=_BIG)
    return torch.cat([lo, hi], -1).to(torch.float32)


def pack_tri_boxes(boxes, valid):
    """Per-triangle cull boxes [T,4] (x0, y0, x1, y1; cull_boxes) as K1
    reads them: [n_chunks, 4, TC] in the chunks' order, invalid and padding
    lanes holding an empty box that overlaps no tile."""
    pad = (0, 0, 0, (-boxes.shape[0]) % TC)
    lo = torch.nn.functional.pad(
        torch.where(valid[:, None], boxes[:, :2], _BIG), pad, value=_BIG)
    hi = torch.nn.functional.pad(
        torch.where(valid[:, None], boxes[:, 2:], -_BIG), pad, value=-_BIG)
    return torch.cat([lo, hi], -1).reshape(-1, TC, 4).permute(0, 2, 1) \
        .contiguous()


WARP_ROWS = 4   # rows of a tile one warp of K1 owns (and culls for)


def lane_survivors(tri_boxes, ci, blk, nbx: int):
    """K1's per-triangle cull: [n, 2, TC] bool, the lanes of chunk ci[i]
    whose box overlaps each half of tile blk[i] (rows 0-3 and 4-7, a
    warp's rectangle), with the strict comparisons of
    build_chunk_lists_2d."""
    b = tri_boxes[ci][:, None]                            # [n, 1, 4, TC]
    halves = [tile_rects(blk, nbx, WARP_ROWS, part) for part in (0, 1)]
    x0, y0, x1, y1 = (torch.stack([h[k] for h in halves], 1)[..., None]
                      for k in range(4))                  # [n, 2, 1] each
    return ((b[:, :, 0] < x1) & (b[:, :, 2] > x0) & (b[:, :, 1] < y1)
            & (b[:, :, 3] > y0))


def tile_walk(lists, counts, n_chunks: int, batch: int):
    """The chunk visits of every tile's walk in K1's order, `batch` tiles at
    a time: yields (j, rows, ci), the tiles `rows` whose j-th visit is chunk
    ci (a tile whose list overflowed visits every chunk in order)."""
    nb, list_w = lists.shape
    full = counts > list_w
    cnt = torch.where(full, n_chunks, counts)
    for j in range(int(cnt.max()) if nb else 0):
        for s in range(0, nb, batch):
            act = cnt[s:s + batch] > j
            if not bool(act.any()):
                continue
            rows = torch.nonzero(act).squeeze(1) + s
            ci = torch.where(full[rows], j,
                             lists[rows, min(j, list_w - 1)]).long()
            yield j, rows, ci


def cull_survivors(tri_boxes, lists, counts, nbx: int, batch: int = 8192):
    """K1's cull replayed on the host over every tile's walk: [nb, V, 2]
    int32, the lanes that survive for each half of a tile at each of its V
    visits (-1 past its last visit)."""
    nb = lists.shape[0]
    per = []
    for j, rows, ci in tile_walk(lists, counts, tri_boxes.shape[0], batch):
        if j == len(per):
            per.append(torch.full((nb, 2), -1, dtype=torch.int32,
                                  device=lists.device))
        per[j][rows] = lane_survivors(tri_boxes, ci, rows, nbx) \
            .sum(-1, dtype=torch.int32)
    if not per:
        return torch.full((nb, 0, 2), -1, dtype=torch.int32,
                          device=lists.device)
    return torch.stack(per, 1)


def _check(t, dtype, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


RASTER_FLOOR_KEY = "rtsdm_raster_blocks:floor"   # K1 with a depth floor


def raster_blocks(coef_chunks, tri_boxes, lists, counts, nby: int,
                  nbx: int, px0: float = 0.5, py0: float = 0.5, floor=None,
                  min_separation: float = 0.0):
    """K1: closest hit per pixel of an [nby*8, nbx*32] image. Pixel (y, x)
    is evaluated at (x + px0, y + py0), px0 and py0 in [0, 1]. tri_boxes
    [n_chunks, 4, TC] are the triangles' cull boxes over the padded image
    (cull_boxes, pack_tri_boxes), with which the kernel culls a chunk's
    triangles per half tile; the cull changes no output, so a CPU tensor
    takes the plain version without it. With `floor` ([nby*8, nbx*32]
    linear view depth) a fragment counts only where its view depth exceeds
    floor + min_separation (depth peeling). Returns (z, tri_id, b1, b2).
    Launches with a floor are counted apart, under RASTER_FLOOR_KEY."""
    with profile_scope("kernel.raster_blocks"):
        for t, dt, n in ((coef_chunks, torch.float32, "coef_chunks"),
                         (tri_boxes, torch.float32, "tri_boxes"),
                         (lists, torch.int32, "lists"),
                         (counts, torch.int32, "counts")):
            _check(t, dt, n)
        if coef_chunks.shape[1:] != (COEF_ROWS, TC) \
                or lists.shape[0] != nby * nbx or counts.shape != (nby * nbx,):
            raise ValueError("raster_blocks: inconsistent shapes")
        if not (0.0 <= px0 <= 1.0 and 0.0 <= py0 <= 1.0):
            raise ValueError("raster_blocks: px0 and py0 must lie in [0, 1], "
                             "the pixel centres the cull boxes bound")
        if tri_boxes.shape != (coef_chunks.shape[0], 4, TC) \
                or tri_boxes.device != coef_chunks.device:
            raise ValueError("raster_blocks: tri_boxes must be [n_chunks, 4, "
                             f"{TC}] beside the chunks, got "
                             f"{tuple(tri_boxes.shape)} on {tri_boxes.device}")
        if floor is not None:
            _check(floor, torch.float32, "floor")
            if floor.shape != (nby * TILE_RH, nbx * TILE_RW) \
                    or floor.device != coef_chunks.device:
                raise ValueError("raster_blocks: floor must be the padded "
                                 "image")
        if coef_chunks.is_cuda:
            dev = coef_chunks.device
            shape = (nby * TILE_RH, nbx * TILE_RW)
            z = torch.empty(shape, dtype=torch.float32, device=dev)
            tid = torch.empty(shape, dtype=torch.int32, device=dev)
            b1 = torch.empty(shape, dtype=torch.float32, device=dev)
            b2 = torch.empty(shape, dtype=torch.float32, device=dev)
            launch("rtsdm_raster_blocks", ptr(coef_chunks), ptr(tri_boxes),
                   ptr(lists), ptr(counts), coef_chunks.shape[0],
                   lists.shape[1], nby, nbx, px0, py0,
                   0 if floor is None else ptr(floor),
                   min_separation, ptr(z), ptr(tid), ptr(b1), ptr(b2),
                   stream_of(coef_chunks),
                   key=None if floor is None else RASTER_FLOOR_KEY)
            return z, tid, b1, b2
        if coef_chunks.device.type != "cpu":
            raise RuntimeError(f"raster_blocks: unsupported device "
                               f"{coef_chunks.device}")
        return raster_blocks_plain(coef_chunks, None, lists, counts, nby, nbx,
                                   px0, py0, floor, min_separation)


def tile_centres(nb: int, nbx: int, px0: float, py0: float, dev):
    """Evaluation points (px, py) [nb, RB] of every pixel of tiles 0..nb-1
    (row-major 8x32 within a tile): pixel (y, x) at (x + px0, y + py0)."""
    t = torch.arange(RB, device=dev)
    blk = torch.arange(nb, device=dev)
    px = ((blk % nbx)[:, None] * TILE_RW + t % TILE_RW).to(torch.float32) \
        + px0
    py = ((blk // nbx)[:, None] * TILE_RH + t // TILE_RW).to(torch.float32) \
        + py0
    return px, py


def fragments(tri, x, y, fl=None):
    """K1's fragment test: tri [na, 17, 1, TC] staged chunks, x, y (and the
    floor plus separation fl) [na, RB, 1] pixel centres. Returns (inside,
    z, e0, e1, e2), each [na, RB, TC]."""
    def edge(r):
        return tri[:, r] * x + tri[:, r + 1] * y + tri[:, r + 2]

    e0, e1, e2, zn, wd = (edge(0), edge(3), edge(6), edge(9), edge(12))
    tol = -1e-5 * (torch.abs(e0) + torch.abs(e1) + torch.abs(e2))
    inside = ((e0 >= tol) & (e1 >= tol) & (e2 >= tol) & (wd > 0.0)
              & (tri[:, 15] > 0.0))
    z = zn / torch.where(wd == 0.0, 1.0, wd)
    inside = inside & (z >= 0.0) & (z <= 1.0)
    if fl is not None:
        es = e0 + e1 + e2
        es = torch.where(es == 0.0, 1.0, es)
        inside = inside & (wd / es > fl)
    return inside, z, e0, e1, e2


def raster_blocks_plain(coef_chunks, tri_boxes, lists, counts, nby: int,
                        nbx: int, px0: float = 0.5, py0: float = 0.5,
                        floor=None, min_separation: float = 0.0,
                        batch: int = 1024):
    """Plain PyTorch version of K1 (same expressions, same tie-breaks):
    all tiles advance through their lists together, `batch` tiles at a
    time to bound the [batch, 256, 128] temporaries. tri_boxes None tests
    every lane of a visited chunk; given (pack_tri_boxes), each half of a
    tile tests only the lanes that survive K1's per-triangle cull for it
    (lane_survivors), which leaves every output as it is without them."""
    dev = coef_chunks.device
    fl = None if floor is None else \
        (tile_flatten(floor) + min_separation).reshape(-1, RB)
    nb = lists.shape[0]
    px, py = tile_centres(nb, nbx, px0, py0, dev)
    best_z = torch.ones((nb, RB), device=dev)
    best_id = torch.full((nb, RB), -1, dtype=torch.int32, device=dev)
    best_b1 = torch.zeros((nb, RB), device=dev)
    best_b2 = torch.zeros((nb, RB), device=dev)
    lane_ids = torch.arange(TC, device=dev)
    for _, rows, ci in tile_walk(lists, counts, coef_chunks.shape[0], batch):
        tri = coef_chunks[ci][:, :, None, :]          # [na,17,1,TC]
        inside, z, e0, e1, e2 = fragments(
            tri, px[rows][:, :, None], py[rows][:, :, None],
            None if fl is None else fl[rows][:, :, None])
        if tri_boxes is not None:   # pixels 0-127 are rows 0-3 of a tile
            inside = inside & lane_survivors(tri_boxes, ci, rows, nbx) \
                .repeat_interleave(RB // 2, 1)
        zm = torch.where(inside, z, 2.0)
        zmin = zm.amin(-1)
        lane = torch.where(zm == zmin[..., None], lane_ids, TC) \
            .amin(-1, keepdim=True)
        lane_c = torch.clamp(lane, max=TC - 1)
        esum = e0 + e1 + e2
        esum = torch.where(esum == 0.0, 1.0, esum).gather(-1, lane_c)
        b1 = (e1.gather(-1, lane_c) / esum)[..., 0]
        b2 = (e2.gather(-1, lane_c) / esum)[..., 0]
        ids = tri[:, 16, 0].gather(-1, lane_c[..., 0]).to(torch.int32)
        upd = (zmin < best_z[rows]) & (zmin <= 1.0)
        best_z[rows] = torch.where(upd, zmin, best_z[rows])
        best_id[rows] = torch.where(upd, ids, best_id[rows])
        best_b1[rows] = torch.where(upd, b1, best_b1[rows])
        best_b2[rows] = torch.where(upd, b2, best_b2[rows])
    hp, wp = nby * TILE_RH, nbx * TILE_RW
    return tuple(tile_unflatten(a.reshape(-1), hp, wp)
                 for a in (best_z, best_id, best_b1, best_b2))


SD_EMPTY = 3e38   # K9's empty slot
# K9 splits each tile's walk over enough warps that the launch has about
# SD_WARPS of them, at most SD_MAX_PARTS per half tile: an SD grid has a
# few hundred tiles, and its heaviest walks (config 2: 47 visits against a
# mean of 10) set the pace. At config 2 the kernel took 0.30 ms in 1 part,
# 0.11 in 4, 0.073 in 16 and no less in 24-48 (chip_smoke.py on an H100
# 80GB HBM3 at 700 W; PERF.md)
SD_WARPS = 8448   # 132 SMs x 64 warps, an SM's most
SD_MAX_PARTS = 16


def sd_parts(nb: int) -> int:
    """Parts K9 splits each of `nb` tiles' walks into."""
    return max(1, min(SD_MAX_PARTS, -(-SD_WARPS // max(2 * nb, 1))))


def raster_stochastic_blocks(coef_chunks, tri_boxes, lists, counts,
                             nby: int, nbx: int, first, ray_min, ray_max,
                             k: int, alpha: float, parts: int | None = None):
    """K9: k-slot stochastic depth over an [nby*8, nbx*32] image (pixel
    centres at +0.5). tri_boxes [n_chunks, 4, TC] are the triangles' cull
    boxes (cull_boxes, pack_tri_boxes), with which the kernel culls a
    chunk's triangles per half tile, as K1 does; the cull changes no
    output, so a CPU tensor takes the plain version without it. first /
    ray_min / ray_max: [nby*8, nbx*32] float32 per-pixel first-layer depth
    and ray interval. `parts` (default sd_parts) splits each tile's walk
    over that many warps per half tile, merged exactly (a minimum). Returns
    [k, nby*8, nbx*32] slot minima of linear view depth, SD_EMPTY where
    empty."""
    with profile_scope("kernel.raster_stochastic_blocks"):
        for t, dt, n in ((coef_chunks, torch.float32, "coef_chunks"),
                         (tri_boxes, torch.float32, "tri_boxes"),
                         (lists, torch.int32, "lists"),
                         (counts, torch.int32, "counts"),
                         (first, torch.float32, "first"),
                         (ray_min, torch.float32, "ray_min"),
                         (ray_max, torch.float32, "ray_max")):
            _check(t, dt, n)
            if t.device != coef_chunks.device:
                raise ValueError(f"raster_stochastic_blocks: {n} on "
                                 f"{t.device}")
        shape = (nby * TILE_RH, nbx * TILE_RW)
        if coef_chunks.shape[1:] != (COEF_ROWS, TC) \
                or tri_boxes.shape != (coef_chunks.shape[0], 4, TC) \
                or lists.shape[0] != nby * nbx \
                or counts.shape != (nby * nbx,) \
                or any(a.shape != shape for a in (first, ray_min, ray_max)):
            raise ValueError("raster_stochastic_blocks: inconsistent shapes")
        if not 1 <= k <= 8:
            raise ValueError(f"raster_stochastic_blocks: k={k} not in 1..8")
        parts = sd_parts(nby * nbx) if parts is None else int(parts)
        if parts < 1:
            raise ValueError(f"raster_stochastic_blocks: parts={parts} < 1")
        if coef_chunks.is_cuda:
            if max(coef_chunks.numel(), lists.numel(), k * shape[0] * shape[1],
                   2 * parts * nby * nbx) >= 2**31:
                raise ValueError("raster_stochastic_blocks: more than 2^31 "
                                 "values")
            lut, idx = coverage_table_tensors(k, coef_chunks.device)
            out = torch.empty((k,) + shape, dtype=torch.float32,
                              device=coef_chunks.device)
            if parts > 1:    # the parts merge by atomicMin into it
                out.fill_(SD_EMPTY)
            launch("rtsdm_raster_stochastic", ptr(coef_chunks), ptr(tri_boxes),
                   ptr(lists), ptr(counts), ptr(first), ptr(ray_min),
                   ptr(ray_max), coef_chunks.shape[0], lists.shape[1], nby,
                   nbx, parts, k, alpha * k, ptr(lut), lut.numel(), ptr(idx),
                   ptr(out), stream_of(coef_chunks))
            return out
        if coef_chunks.device.type != "cpu":
            raise RuntimeError(f"raster_stochastic_blocks: unsupported device "
                               f"{coef_chunks.device}")
        return raster_stochastic_blocks_plain(coef_chunks, None, lists,
                                              counts, nby, nbx, first,
                                              ray_min, ray_max, k, alpha)


def fragment_draws(px, py, oid):
    """K9's two uniform draws of a fragment (raster_pallas.py:272-283):
    the int32 hash of the truncated pixel centre and the triangle's
    original id, evaluated in int64 with explicit 32-bit wrapping. px, py,
    oid: float32 tensors of one shape. Returns float32 (rng, rng2)."""
    oid_i = oid.to(torch.int64)
    hb = _wrap32(_wrap32(px.to(torch.int64) * 374761393)
                 ^ _wrap32(py.to(torch.int64) * 668265263)
                 ^ _wrap32(oid_i << 7))
    hb = _wrap32((hb ^ (hb >> 13)) * 0x9E3779B1)
    hb = hb ^ (hb >> 16)
    rng = key15_of_hash(hb).to(torch.float32) * (1.0 / 32767.0)
    h2 = (hb ^ _wrap32(oid_i * 0x9E3779B1)) ^ (hb >> 5)
    rng2 = key15_of_hash(h2).to(torch.float32) * (1.0 / 32767.0)
    return rng, rng2


SD_PLAIN_BATCH = 256   # tiles per step of K9's plain version


def raster_stochastic_blocks_plain(coef_chunks, tri_boxes, lists, counts,
                                   nby: int, nbx: int, first, ray_min,
                                   ray_max, k: int, alpha: float,
                                   part: tuple[int, int] | None = None):
    """Plain PyTorch version of K9 (same expressions): all tiles advance
    through their lists together, SD_PLAIN_BATCH tiles at a time.
    tri_boxes None tests every lane of a visited chunk; given
    (pack_tri_boxes), each half of a tile tests only the lanes that survive
    K9's per-triangle cull for it (lane_survivors), which leaves every slot
    as it is without them. part (p, parts) walks only the visits j with
    j % parts == p, one of the kernel's split parts."""
    dev = coef_chunks.device
    nb = lists.shape[0]
    px, py = tile_centres(nb, nbx, 0.5, 0.5, dev)
    fi = (tile_flatten(first) + 0.01).reshape(nb, RB)
    rmn = tile_flatten(ray_min).reshape(nb, RB)
    rmx = tile_flatten(ray_max).reshape(nb, RB)
    slots = torch.full((k, nb, RB), SD_EMPTY, device=dev)
    for j, rows, ci in tile_walk(lists, counts, coef_chunks.shape[0],
                                 SD_PLAIN_BATCH):
        if part is not None and j % part[1] != part[0]:
            continue
        tri = coef_chunks[ci][:, :, None, :]          # [na,17,1,TC]
        x, y = px[rows][:, :, None], py[rows][:, :, None]

        def edge(r):
            return tri[:, r] * x + tri[:, r + 1] * y + tri[:, r + 2]

        e0, e1, e2, zn, wd = (edge(0), edge(3), edge(6), edge(9), edge(12))
        inside = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (wd > 0.0)
                  & (tri[:, 15] > 0.0))
        if tri_boxes is not None:   # pixels 0-127 are rows 0-3 of a tile
            inside = inside & lane_survivors(tri_boxes, ci, rows, nbx) \
                .repeat_interleave(RB // 2, 1)
        z = zn / torch.where(wd == 0.0, 1.0, wd)
        inside = inside & (z >= 0.0) & (z <= 1.0)
        esum = e0 + e1 + e2
        vd = wd / torch.where(esum == 0.0, 1.0, esum)
        rn, rx = rmn[rows][:, :, None], rmx[rows][:, :, None]
        inside = (inside & (vd > fi[rows][:, :, None])
                  & ((rn == 0.0) | (vd >= rn)) & (rx != 0.0) & (vd <= rx))
        rng, rng2 = fragment_draws(x.expand_as(vd), y.expand_as(vd),
                                   tri[:, 16].expand_as(vd))
        mask = coverage_mask_select(alpha, rng, rng2, k)
        vd = torch.where(inside, vd, SD_EMPTY)
        for q in range(k):
            m = torch.where(((mask >> q) & 1) > 0, vd, SD_EMPTY).amin(-1)
            slots[q, rows] = torch.minimum(slots[q, rows], m)
    hp, wp = nby * TILE_RH, nbx * TILE_RW
    return torch.stack([tile_unflatten(a.reshape(-1), hp, wp)
                        for a in slots])


def pack_attr_rows(interp, flats):
    """Attribute table [T, NR] for K2 (counterpart of raster_pallas.
    pack_attr_chunks): per vertex attribute [T,3,C], rows 3i+v = component
    i at vertex v; then the flat [T] / [T,C] per-triangle columns."""
    cols = [a.to(torch.float32).transpose(1, 2).reshape(a.shape[0], -1)
            for a in interp]
    nci = sum(c.shape[1] for c in cols) // 3
    nflat = 0
    for f in flats:
        f = f.to(torch.float32)
        f = f[:, None] if f.ndim == 1 else f
        nflat += f.shape[1]
        cols.append(f)
    return torch.cat(cols, 1).contiguous(), nci, nflat


FETCH_PIX = 256                  # csrc/raster.cu: K2's block stages its
FETCH_SHARED_BYTES = 48 * 1024   # pixels' output rows in shared memory


def fetch_attributes(tri_id, bary, table, nci: int, nflat: int):
    """K2: per pixel, b0*a0 + b1*a1 + b2*a2 of the winner's vertex rows
    (b0 = 1 - b1 - b2) for the nci interpolated components, then its nflat
    flat entries; background pixels (tri_id < 0) are 0. Returns
    [H, W, nci + nflat]."""
    with profile_scope("kernel.fetch_attributes"):
        _check(tri_id, torch.int32, "tri_id")
        _check(bary, torch.float32, "bary")
        _check(table, torch.float32, "table")
        if table.shape[1] != 3 * nci + nflat \
                or bary.shape != tri_id.shape + (2,):
            raise ValueError("fetch_attributes: inconsistent shapes")
        if tri_id.is_cuda:
            if (nci + nflat) * FETCH_PIX * 4 > FETCH_SHARED_BYTES:
                raise ValueError(f"fetch_attributes: {nci + nflat} outputs a "
                                 f"pixel exceed the kernel's shared memory")
            if tri_id.numel() >= 2**31:
                raise ValueError("fetch_attributes: more than 2^31 pixels")
            if bary.data_ptr() % 8:
                bary = bary.clone()     # read as float2
            out = torch.empty(tri_id.shape + (nci + nflat,),
                              dtype=torch.float32, device=tri_id.device)
            launch("rtsdm_fetch_attributes", ptr(tri_id), ptr(bary),
                   ptr(table), tri_id.numel(), nci, nflat, ptr(out),
                   stream_of(tri_id))
            return out
        if tri_id.device.type != "cpu":
            raise RuntimeError(f"fetch_attributes: unsupported device "
                               f"{tri_id.device}")
        return fetch_attributes_plain(tri_id, bary, table, nci, nflat)


def fetch_attributes_plain(tri_id, bary, table, nci: int, nflat: int):
    """Plain PyTorch version of K2."""
    from .raster import flat_fetch, interpolate
    t = table.shape[0]
    vert = table[:, :3 * nci].reshape(t, nci, 3).transpose(1, 2)  # [T,3,nci]
    flat = flat_fetch(tri_id, table[:, 3 * nci:])
    flat = torch.where((tri_id >= 0)[..., None], flat, 0.0)
    return torch.cat([interpolate(tri_id, bary, vert), flat], -1)
