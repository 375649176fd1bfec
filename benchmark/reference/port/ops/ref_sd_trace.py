"""The reference's stochastic-depth trace: the function of the port's K5
and K7 (one ray per SD texel from the pinhole origin, each hit packed as
its 15-bit hash key over its 16-bit depth, the k smallest distinct values
kept) computed without the port's chunks, chunk boxes, screen rows or
lists.

The cull works on whole triangles and the rays' own directions:

* every ray's direction d is put on the plane one unit along the view
  axis w (float64; the axis along which the rays' depth scales advance):
  (a, b) = (d.u / d.w, d.v / d.w), u and v completing w to an
  orthonormal basis;
* a hit lies at t > tmin along its ray, so its w-coordinate from the
  origin is above half the least tmin * d.w of the live rays, w_clip: each
  triangle is clipped to w >= w_clip and its clipped corners projected to
  the same plane, a box that holds the (a, b) of every ray that can hit
  it; a triangle with nothing left (behind the eye) is dropped;
* the box, widened by 1e-4 of its size plus 1e-6 of its place, is tested
  against the rays of the cells of a grid over the rays' (a, b), about 32
  rays a cell, and then against each ray's own (a, b).

Surviving (ray, triangle) pairs are evaluated with the trace's own hit
test on the shared-origin rows that ops/rt_cuda.prep_triangles_packed
makes (the Moller-Trumbore terms of rt_pallas.py, float32, in the same
order of operations), so each hit's depth and hash are the ones K5
computes. Only the default insertion without MaxCount is here, the one
both benchmark graphs run; the k smallest distinct values of a set do not
depend on the order the hits come in, so none is imposed.
"""
from __future__ import annotations

import math

import torch

from .rt_cuda import EPS_DET, INVALID, key15_of_hash, sd_hash

RAYS_A_CELL = 32
PAIR_BATCH = 1 << 22   # (ray, triangle) pairs evaluated at once
HIT_PRUNE = 1 << 24    # accepted hits kept before the smallest k are taken


def _basis(dirs64, vz64):
    """Orthonormal (u, v, w) [3] float64, w the axis along which the rays
    advance by vz (their view-depth scales: the pinhole's view axis), by
    least squares."""
    w = torch.linalg.lstsq(dirs64, vz64[:, None]).solution[:, 0]
    w = w / w.norm()
    helper = torch.zeros_like(w)
    helper[int(torch.argmin(w.abs()))] = 1.0
    u = torch.linalg.cross(helper, w)
    u = u / u.norm()
    return u, torch.linalg.cross(w, u), w


def _triangle_boxes(pos64, origin64, u, v, w, w_clip):
    """[T, 4] float64 (a0, b0, a1, b1) of each triangle's part at
    w >= w_clip projected to the unit plane, and [T] bool: something is
    left."""
    p = pos64 - origin64                                   # [T, 3, 3]
    pu, pv, pw = p @ u, p @ v, p @ w                       # [T, 3]
    pts_a, pts_b, keep = [pu / pw.clamp(min=w_clip)], \
        [pv / pw.clamp(min=w_clip)], [pw >= w_clip]
    for i, j in ((0, 1), (1, 2), (2, 0)):
        wi, wj = pw[:, i], pw[:, j]
        cross = (wi - w_clip) * (wj - w_clip) < 0.0
        s = torch.where(cross, (w_clip - wi) / torch.where(cross, wj - wi,
                                                            1.0), 0.0)
        cu = pu[:, i] + s * (pu[:, j] - pu[:, i])
        cv = pv[:, i] + s * (pv[:, j] - pv[:, i])
        pts_a.append((cu / w_clip)[:, None])
        pts_b.append((cv / w_clip)[:, None])
        keep.append(cross[:, None])
    a, b, ok = (torch.cat(x, 1) for x in (pts_a, pts_b, keep))
    big = torch.tensor(math.inf, dtype=a.dtype, device=a.device)
    a0 = torch.where(ok, a, big).amin(1)
    a1 = torch.where(ok, a, -big).amax(1)
    b0 = torch.where(ok, b, big).amin(1)
    b1 = torch.where(ok, b, -big).amax(1)
    live = ok.any(1)
    box = torch.stack([a0, b0, a1, b1], 1)
    ext = torch.stack([a1 - a0, b1 - b0], 1).where(live[:, None], 0.0)
    place = torch.stack([torch.maximum(a0.abs(), a1.abs()),
                         torch.maximum(b0.abs(), b1.abs())], 1) \
        .where(live[:, None], 0.0)
    pad = 1e-4 * ext + 1e-6 * (place + 1.0)
    box = box + torch.cat([-pad, pad], 1)
    return box, live


def _hits(tri, rays, ti, ri, cull_back: bool):
    """Packed values (INVALID where no hit) of the pairs (ti, ri): the hit
    test and packing of the trace, float32."""
    t_ = tri[ti]                                           # [P, 16]
    dx, dy, dz, tmin, tmax, za, zb = (rays[i, ri] for i in range(7))
    det = dx * t_[:, 0] + dy * t_[:, 1] + dz * t_[:, 2]
    pu = dx * t_[:, 4] + dy * t_[:, 5] + dz * t_[:, 6]
    pv = dx * t_[:, 8] + dy * t_[:, 9] + dz * t_[:, 10]
    tp = t_[:, 3]
    if cull_back:
        ok = det > EPS_DET
        adet, spu, spv, stp = det, pu, pv, tp
    else:
        ok = (torch.abs(det) > EPS_DET) & ((det > 0.0) | (t_[:, 7] > 0.0))
        sg = torch.where(det >= 0.0, 1.0, -1.0)
        adet, spu, spv, stp = det * sg, pu * sg, pv * sg, tp * sg
    ok = ok & (t_[:, 11] == 0.0)
    ok = ok & (spu >= 0.0) & (spv >= 0.0) & (spu + spv <= adet) \
        & (stp > tmin * adet) & (stp < tmax * adet)
    inv = 1.0 / torch.where(torch.abs(det) < EPS_DET, 1.0, det)
    u = torch.where(ok, pu * inv, 0.0)
    v = torch.where(ok, pv * inv, 0.0)
    t = torch.where(ok, tp * inv, 0.0)
    cell = (torch.clamp(u * 4.0, 0.0, 3.0).to(torch.int32)
            + 4 * torch.clamp(v * 4.0, 0.0, 3.0).to(torch.int32))
    abit = torch.bitwise_right_shift(t_[:, 12].to(torch.int32), cell) & 1
    ok = ok & (abit > 0)
    d_norm = torch.clamp(t * za - zb, 0.0, 1.0)
    d16 = torch.clamp((d_norm * 65535.0).to(torch.int64), 0, 65535)
    packed = key15_of_hash(sd_hash(u, v)) * 65536 + d16
    return torch.where(ok, packed, INVALID)


def _smallest(keys, k: int):
    """Of int64 keys ray * 2**31 + value, the k smallest distinct values a
    ray, as keys."""
    keys = torch.unique(keys)
    ray = keys >> 31
    first = torch.ones_like(ray, dtype=torch.bool)
    first[1:] = ray[1:] != ray[:-1]
    idx = torch.arange(keys.numel(), device=keys.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    return keys[idx - start < k]


def sd_trace(positions, tri_packed, origin, dirs, tmin, tmax, vz_scale, near,
             far, *, num_samples: int = 4, cull_back: bool = True,
             mode: str = "default", max_count: int = 0, alpha: float = 0.2):
    """Packed slots [R, num_samples] int32 (ascending, INVALID = empty) of
    rays dirs [R, 3] with tmin, tmax, vz_scale [R] from `origin` [3] among
    the triangles positions [T, 3, 3] (world), whose shared-origin rows are
    tri_packed [n_chunks, 128, 16] (slot i: triangle i)."""
    del alpha
    if mode != "default" or max_count:
        raise NotImplementedError(
            "ref_sd_trace: only the default insertion without MaxCount")
    dev = dirs.device
    k = int(num_samples)
    r = dirs.shape[0]
    inv_range = 1.0 / (far - near)
    rays = torch.stack([dirs[:, 0], dirs[:, 1], dirs[:, 2], tmin, tmax,
                        vz_scale * inv_range,
                        (near * inv_range).expand(r)]).contiguous()
    tri = tri_packed.reshape(-1, tri_packed.shape[-1])
    slots = torch.full((r, k), INVALID, dtype=torch.int64, device=dev)
    live_r = torch.nonzero(tmax > tmin).squeeze(1)
    n_tri = positions.shape[0]
    if live_r.numel() == 0 or n_tri == 0:
        return slots.to(torch.int32)
    d64 = dirs[live_r].double()
    u, v, w = _basis(d64, vz_scale[live_r].double())
    dw = d64 @ w
    if not bool((dw > 0).all()):
        raise ValueError("ref_sd_trace: a ray points away from the view "
                         "axis")
    ra, rb = (d64 @ u) / dw, (d64 @ v) / dw
    w_clip = 0.5 * float((tmin[live_r].double() * dw).min())
    if not w_clip > 0.0:
        raise ValueError("ref_sd_trace: tmin must be above 0")
    box, live_t = _triangle_boxes(positions.double(), origin.double(), u, v,
                                  w, w_clip)
    # the grid over the rays' (a, b), rays sorted by cell
    n_cells = max(1, live_r.numel() // RAYS_A_CELL)
    ga = gb = max(1, int(math.sqrt(n_cells)))
    a_lo, a_hi = float(ra.min()), float(ra.max())
    b_lo, b_hi = float(rb.min()), float(rb.max())
    sa = ga / max(a_hi - a_lo, 1e-30)
    sb = gb / max(b_hi - b_lo, 1e-30)
    ca = ((ra - a_lo) * sa).long().clamp(0, ga - 1)
    cb = ((rb - b_lo) * sb).long().clamp(0, gb - 1)
    order = torch.argsort(cb * ga + ca)
    ray_sorted = live_r[order]
    ra_s, rb_s = ra[order], rb[order]
    counts = torch.bincount(cb * ga + ca, minlength=ga * gb)
    starts = torch.cumsum(counts, 0) - counts
    # each triangle's cell rectangle
    live_t &= (box[:, 2] >= a_lo) & (box[:, 0] <= a_hi) \
        & (box[:, 3] >= b_lo) & (box[:, 1] <= b_hi)
    tid = torch.nonzero(live_t).squeeze(1)
    bx = box[tid]
    ca0 = ((bx[:, 0] - a_lo) * sa).floor().clamp(0, ga - 1).long()
    ca1 = ((bx[:, 2] - a_lo) * sa).floor().clamp(0, ga - 1).long()
    cb0 = ((bx[:, 1] - b_lo) * sb).floor().clamp(0, gb - 1).long()
    cb1 = ((bx[:, 3] - b_lo) * sb).floor().clamp(0, gb - 1).long()
    na, nb = ca1 - ca0 + 1, cb1 - cb0 + 1
    n_tc = na * nb
    pair_t = torch.repeat_interleave(torch.arange(tid.numel(), device=dev),
                                     n_tc)
    off = torch.arange(pair_t.numel(), device=dev) \
        - torch.repeat_interleave(torch.cumsum(n_tc, 0) - n_tc, n_tc)
    cell = (cb0[pair_t] + off // na[pair_t]) * ga + ca0[pair_t] \
        + off % na[pair_t]
    # (triangle, cell) pairs in batches of about PAIR_BATCH (ray, triangle)
    cnt = counts[cell]
    ends = torch.cumsum(cnt, 0)
    keys = []
    n_keys = 0
    lo = 0
    while lo < cell.numel():
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + PAIR_BATCH, right=True))
        hi = max(hi, lo + 1)
        c, t_loc = cell[lo:hi], pair_t[lo:hi]
        m = cnt[lo:hi]
        rep = torch.repeat_interleave(torch.arange(c.numel(), device=dev), m)
        j = torch.arange(rep.numel(), device=dev) \
            - torch.repeat_interleave(torch.cumsum(m, 0) - m, m)
        slot = starts[c][rep] + j
        tl = t_loc[rep]
        inside = (ra_s[slot] >= bx[tl, 0]) & (ra_s[slot] <= bx[tl, 2]) \
            & (rb_s[slot] >= bx[tl, 1]) & (rb_s[slot] <= bx[tl, 3])
        slot, tl = slot[inside], tl[inside]
        ri = ray_sorted[slot]
        packed = _hits(tri, rays, tid[tl], ri, cull_back)
        hit = packed != INVALID
        if bool(hit.any()):
            keys.append(ri[hit] * 2**31 + packed[hit])
            n_keys += keys[-1].numel()
            if n_keys > HIT_PRUNE:
                keys = [_smallest(torch.cat(keys), k)]
                n_keys = keys[0].numel()
        lo = hi
    if keys:
        kept = _smallest(torch.cat(keys), k)
        ray = kept >> 31
        first = torch.ones_like(ray, dtype=torch.bool)
        first[1:] = ray[1:] != ray[:-1]
        idx = torch.arange(kept.numel(), device=dev)
        rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
        slots[ray, rank] = kept & (2**31 - 1)
    return slots.to(torch.int32)
