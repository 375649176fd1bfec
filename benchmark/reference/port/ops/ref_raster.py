"""The reference's visibility raster: the contract of the port's K1
(ops/raster_cuda.raster_blocks_plain without a cull: every valid triangle
tested at every pixel, the closest fragment kept, ties to the triangle
first in screen-morton order) computed with a cull of its own, so that it
takes seconds and not minutes at a million triangles.

The cull works on whole triangles and 8x8 pixel tiles, never on the port's
chunks, lists or cull boxes:

* a triangle whose three clip-space w lie below -1e-3 of their largest
  magnitude is behind the eye: K1's test needs the w interpolant wd > 0,
  and wd is a sum of the edge values weighted by the vertices' w, so with
  the edge values all above -1e-5 of their sum it stays negative;
* a triangle wholly in front tests the tiles of its pixel box (K1's own
  box from _setup_triangles, which bounds its fragments);
* a triangle that crosses the eye's plane tests every tile of the image;
* every candidate tile is then tested in float64 at its four pixel-centre
  corners: it is dropped when one edge function, the w interpolant or the
  z interpolant stays below minus a margin over the whole tile (each is
  linear in the pixel position; the margin, 3e-5 of the largest sum of
  |edge values| plus 1e-5 of the terms' magnitude, covers K1's tolerance
  and its float32 rounding).

Surviving (tile, triangle) pairs are expanded to their 64 pixels and
evaluated with K1's own fragment test (raster_cuda.fragments), one pair at
a time in float32, so each fragment's depth and barycentrics are the ones
K1 computes. `record`, when a list, receives one dict per call: the
triangles, pixels and accepted fragments (the coverages the roofline
counts), which the benchmark's metric readers read.
"""
from __future__ import annotations

import torch

from . import raster_cuda
from ..utils.math import transform_point

TILE = 8              # pixels a side of a cull tile
PAIR_BATCH = 1 << 22  # (pixel, triangle) pairs evaluated at once
TILE_BATCH = 1 << 22  # (tile, triangle) pairs tested at once
BEHIND = 1e-3

record = None  # a list to append per-call counts to, or None


def _corner_max(coef3, x0, y0, x1, y1):
    """Largest value over the rectangle's corners of the linear functions
    c . (px, py, 1) (coef3 [P, 3] float64; corners [P] float64), and the
    largest magnitude of its terms there."""
    cx, cy, cz = coef3.unbind(-1)
    vals = torch.stack([cx * x0 + cy * y0, cx * x1 + cy * y0,
                        cx * x0 + cy * y1, cx * x1 + cy * y1], -1) + cz[:, None]
    mag = (cx.abs() * torch.maximum(x0.abs(), x1.abs())
           + cy.abs() * torch.maximum(y0.abs(), y1.abs()) + cz.abs())
    return vals, mag


def _tile_survives(coef64, tid, ty, tx, width: int, height: int):
    """[P] bool: can tile (ty, tx) hold a fragment of triangle tid?"""
    c = coef64[tid]                                   # [P, 5, 3]
    x0 = (tx * TILE).double() + 0.5
    y0 = (ty * TILE).double() + 0.5
    x1 = torch.minimum(x0 + (TILE - 1), torch.full_like(x0, width - 0.5))
    y1 = torch.minimum(y0 + (TILE - 1), torch.full_like(y0, height - 0.5))
    vals, mags = zip(*(_corner_max(c[:, r], x0, y0, x1, y1)
                       for r in range(5)))
    esum = (vals[0].abs() + vals[1].abs() + vals[2].abs()).amax(-1)
    ok = torch.ones_like(x0, dtype=torch.bool)
    for r in range(5):
        margin = 3e-5 * esum * (r < 3) + 1e-5 * mags[r] + 1e-30
        ok &= vals[r].amax(-1) >= -margin
    return ok


def _candidates(coef, bbox, valid, w, width: int, height: int):
    """(tri, ty, tx) int64 of the (triangle, tile) pairs that survive."""
    dev = coef.device
    nty, ntx = -(-height // TILE), -(-width // TILE)
    wmax = w.abs().amax(-1)
    front = valid & (w > 1e-9).all(-1)
    behind = (w < -BEHIND * wmax[:, None]).all(-1)
    cross = valid & ~front & ~behind
    # tiles of each front triangle's pixel box, plus every tile for the
    # triangles that cross the eye's plane
    tx0 = torch.div(bbox[:, 0], TILE, rounding_mode="floor").long()
    ty0 = torch.div(bbox[:, 1], TILE, rounding_mode="floor").long()
    tx1 = torch.ceil(bbox[:, 2] / TILE).long().clamp(max=ntx)
    ty1 = torch.ceil(bbox[:, 3] / TILE).long().clamp(max=nty)
    tx0 = torch.where(cross, 0, tx0)
    ty0 = torch.where(cross, 0, ty0)
    tx1 = torch.where(cross, ntx, tx1)
    ty1 = torch.where(cross, nty, ty1)
    keep = front | cross
    nx = torch.where(keep, (tx1 - tx0).clamp(min=0), 0)
    ny = torch.where(keep, (ty1 - ty0).clamp(min=0), 0)
    n = nx * ny
    coef64 = coef.double()
    tri_all = torch.nonzero(n > 0).squeeze(1)
    out = []
    # expand in batches of triangles so the (tile, triangle) pairs stay
    # bounded
    csum = torch.cumsum(n[tri_all], 0)
    start = 0
    while start < tri_all.shape[0]:
        base = csum[start - 1] if start else csum.new_zeros(())
        stop = int(torch.searchsorted(csum, base + TILE_BATCH, right=True))
        stop = max(stop, start + 1)
        tris = tri_all[start:stop]
        cnt = n[tris]
        tri = torch.repeat_interleave(tris, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(tri.shape[0], device=dev) \
            - torch.repeat_interleave(first, cnt)
        ty = ty0[tri] + torch.div(k, nx[tri], rounding_mode="floor")
        tx = tx0[tri] + k % nx[tri]
        ok = _tile_survives(coef64, tri, ty, tx, width, height)
        out.append((tri[ok], ty[ok], tx[ok]))
        start = stop
    if not out:
        e = torch.zeros((0,), dtype=torch.long, device=dev)
        return e, e, e
    return tuple(torch.cat(a) for a in zip(*out))


def rasterize_reference(view_proj, positions, *, width: int, height: int,
                        jitter_x=0.0, jitter_y=0.0, cull: str = "back",
                        depth_floor=None, min_separation: float = 0.0):
    """rasterize()'s outputs (tri_id, bary, depth, overflow = 0) by the
    contract of K1, with the reference's own cull (module docstring)."""
    from .raster import CULL_MODES, _setup_triangles
    dev = positions.device
    coef, bbox, valid = _setup_triangles(view_proj, positions, width, height,
                                         jitter_x, jitter_y, CULL_MODES[cull])
    w = transform_point(view_proj, positions)[..., 3]
    order = raster_cuda.screen_morton_order(bbox, valid, width, height)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev)
    t = coef.shape[0]
    rows = torch.cat([coef.reshape(t, 15), valid.to(torch.float32)[:, None],
                      torch.arange(t, device=dev,
                                   dtype=torch.float32)[:, None]], 1)
    fl_img = None
    if depth_floor is not None:
        fl_img = depth_floor.to(torch.float32) + min_separation
    tri, ty, tx = _candidates(coef, bbox, valid, w, width, height)

    npix = width * height
    best = torch.full((npix,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    pix_in_tile = torch.arange(TILE * TILE, device=dev)
    coverages = 0
    step = max(1, PAIR_BATCH // (TILE * TILE))
    for s in range(0, tri.shape[0], step):
        tr = tri[s:s + step]
        x = (tx[s:s + step, None] * TILE + pix_in_tile % TILE).reshape(-1)
        y = (ty[s:s + step, None] * TILE + pix_in_tile // TILE).reshape(-1)
        tr = tr[:, None].expand(-1, TILE * TILE).reshape(-1)
        inb = (x < width) & (y < height)
        x, y, tr = x[inb], y[inb], tr[inb]
        pix = y * width + x
        fl = None if fl_img is None else fl_img.reshape(-1)[pix][:, None, None]
        inside, z, _, _, _ = raster_cuda.fragments(
            rows[tr][:, :, None, None],
            (x.to(torch.float32) + 0.5)[:, None, None],
            (y.to(torch.float32) + 0.5)[:, None, None], fl)
        inside, z = inside.reshape(-1), z.reshape(-1)
        coverages += int(inside.sum())
        # K1 keeps a fragment only below the depth it holds (1.0 at first)
        keep = inside & (z < 1.0)
        zb = (z[keep] + 0.0).view(torch.int32).to(torch.int64)
        key = (zb << 32) | rank[tr[keep]]
        best.scatter_reduce_(0, pix[keep], key, "amin")
    hit = best != torch.iinfo(torch.int64).max
    win = torch.where(hit, order[(best & 0xFFFFFFFF).clamp(
        max=t - 1)], 0)
    ys = torch.div(torch.arange(npix, device=dev), width,
                   rounding_mode="floor")
    xs = torch.arange(npix, device=dev) % width
    _, z, e0, e1, e2 = raster_cuda.fragments(
        rows[win][:, :, None, None], (xs.to(torch.float32) + 0.5)[:, None, None],
        (ys.to(torch.float32) + 0.5)[:, None, None])
    e0, e1, e2, z = (a.reshape(-1) for a in (e0, e1, e2, z))
    esum = e0 + e1 + e2
    esum = torch.where(esum == 0.0, 1.0, esum)
    b1 = torch.where(hit, e1 / esum, 0.0)
    b2 = torch.where(hit, e2 / esum, 0.0)
    depth = torch.where(hit, z, 1.0)
    tid = torch.where(hit, win, -1).to(torch.int32)
    if record is not None:
        record.append({"triangles": t, "pixels": npix,
                       "coverages": coverages,
                       "floored": depth_floor is not None})
    return {"tri_id": tid.reshape(height, width),
            "bary": torch.stack([b1, b2], -1).reshape(height, width, 2),
            "depth": depth.reshape(height, width),
            "overflow": torch.zeros((), dtype=torch.int64, device=dev)}
