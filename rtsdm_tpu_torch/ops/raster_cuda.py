"""Sort-middle visibility raster (K1) and attribute fetch (K2): the wrappers
of csrc/raster.cu, their plain PyTorch versions, and the tensor code around
them (counterpart of rtsdm_tpu/ops/raster_pallas.py).

Per frame: triangles are re-sorted by the screen-space morton code of their
bbox centre (so 128-triangle chunks are screen-compact), packed into
[n_chunks, 17, 128] coefficient chunks, and every 8x32-pixel tile gets the
ascending list of chunks whose screen bbox overlaps it. K1 walks each
tile's list. A wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import torch

from .._build import launch, ptr, stream_of
from .rt_cuda import (LIST_CAP, RB, TC, TILE_RH, TILE_RW, compact_lists,
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


def build_chunk_lists_2d(cbox, nby: int, nbx: int):
    """Per-tile chunk lists in screen space: tile (by, bx) covers pixels
    [bx*32, bx*32+32) x [by*8, by*8+8)."""
    nb = nby * nbx
    blk = torch.arange(nb, dtype=torch.int32, device=cbox.device)
    by = (blk // nbx).to(torch.float32)
    bx = (blk % nbx).to(torch.float32)
    x0, y0 = bx * TILE_RW, by * TILE_RH
    x1, y1 = x0 + TILE_RW, y0 + TILE_RH
    overlap = ((cbox[0][None, :] < x1[:, None])
               & (cbox[2][None, :] > x0[:, None])
               & (cbox[1][None, :] < y1[:, None])
               & (cbox[3][None, :] > y0[:, None]))
    return compact_lists(overlap, LIST_CAP)


def _check(t, dtype, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raster_blocks(coef_chunks, lists, counts, nby: int, nbx: int,
                  px0: float = 0.5, py0: float = 0.5):
    """K1: closest hit per pixel of an [nby*8, nbx*32] image. Pixel (y, x)
    is evaluated at (x + px0, y + py0). Returns (z, tri_id, b1, b2)."""
    for t, dt, n in ((coef_chunks, torch.float32, "coef_chunks"),
                     (lists, torch.int32, "lists"),
                     (counts, torch.int32, "counts")):
        _check(t, dt, n)
    if coef_chunks.shape[1:] != (COEF_ROWS, TC) \
            or lists.shape[0] != nby * nbx or counts.shape != (nby * nbx,):
        raise ValueError("raster_blocks: inconsistent shapes")
    if coef_chunks.is_cuda:
        dev = coef_chunks.device
        shape = (nby * TILE_RH, nbx * TILE_RW)
        z = torch.empty(shape, dtype=torch.float32, device=dev)
        tid = torch.empty(shape, dtype=torch.int32, device=dev)
        b1 = torch.empty(shape, dtype=torch.float32, device=dev)
        b2 = torch.empty(shape, dtype=torch.float32, device=dev)
        launch("rtsdm_raster_blocks", ptr(coef_chunks), ptr(lists),
               ptr(counts), coef_chunks.shape[0], lists.shape[1], nby, nbx,
               px0, py0, ptr(z), ptr(tid), ptr(b1), ptr(b2),
               stream_of(coef_chunks))
        return z, tid, b1, b2
    if coef_chunks.device.type != "cpu":
        raise RuntimeError(f"raster_blocks: unsupported device "
                           f"{coef_chunks.device}")
    return raster_blocks_plain(coef_chunks, lists, counts, nby, nbx, px0, py0)


def raster_blocks_plain(coef_chunks, lists, counts, nby: int, nbx: int,
                        px0: float = 0.5, py0: float = 0.5,
                        batch: int = 1024):
    """Plain PyTorch version of K1 (same expressions, same tie-breaks):
    all tiles advance through their lists together, `batch` tiles at a
    time to bound the [batch, 256, 128] temporaries."""
    dev = coef_chunks.device
    nb, list_w = lists.shape
    n_chunks = coef_chunks.shape[0]
    full = counts > list_w
    cnt = torch.where(full, n_chunks, counts)
    t = torch.arange(RB, device=dev)
    blk = torch.arange(nb, device=dev)
    px = ((blk % nbx)[:, None] * TILE_RW + t % TILE_RW).to(torch.float32) \
        + px0
    py = ((blk // nbx)[:, None] * TILE_RH + t // TILE_RW).to(torch.float32) \
        + py0
    best_z = torch.ones((nb, RB), device=dev)
    best_id = torch.full((nb, RB), -1, dtype=torch.int32, device=dev)
    best_b1 = torch.zeros((nb, RB), device=dev)
    best_b2 = torch.zeros((nb, RB), device=dev)
    lane_ids = torch.arange(TC, device=dev)
    for j in range(int(cnt.max()) if nb else 0):
        for s in range(0, nb, batch):
            sl = slice(s, min(s + batch, nb))
            act = cnt[sl] > j
            if not bool(act.any()):
                continue
            rows = torch.nonzero(act).squeeze(1) + s
            ci = torch.where(full[rows], j,
                             lists[rows, min(j, list_w - 1)]).long()
            tri = coef_chunks[ci][:, :, None, :]          # [na,17,1,TC]
            x, y = px[rows][:, :, None], py[rows][:, :, None]

            def edge(r):
                return tri[:, r] * x + tri[:, r + 1] * y + tri[:, r + 2]

            e0, e1, e2, zn, wd = (edge(0), edge(3), edge(6), edge(9),
                                  edge(12))
            tol = -1e-5 * (torch.abs(e0) + torch.abs(e1) + torch.abs(e2))
            inside = ((e0 >= tol) & (e1 >= tol) & (e2 >= tol) & (wd > 0.0)
                      & (tri[:, 15] > 0.0))
            z = zn / torch.where(wd == 0.0, 1.0, wd)
            inside = inside & (z >= 0.0) & (z <= 1.0)
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


def fetch_attributes(tri_id, bary, table, nci: int, nflat: int):
    """K2: per pixel, b0*a0 + b1*a1 + b2*a2 of the winner's vertex rows
    (b0 = 1 - b1 - b2) for the nci interpolated components, then its nflat
    flat entries; background pixels (tri_id < 0) are 0. Returns
    [H, W, nci + nflat]."""
    _check(tri_id, torch.int32, "tri_id")
    _check(bary, torch.float32, "bary")
    _check(table, torch.float32, "table")
    if table.shape[1] != 3 * nci + nflat or bary.shape != tri_id.shape + (2,):
        raise ValueError("fetch_attributes: inconsistent shapes")
    if tri_id.is_cuda:
        out = torch.empty(tri_id.shape + (nci + nflat,), dtype=torch.float32,
                          device=tri_id.device)
        launch("rtsdm_fetch_attributes", ptr(tri_id), ptr(bary), ptr(table),
               tri_id.numel(), table.shape[1], nci, nflat, ptr(out),
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
