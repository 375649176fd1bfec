"""The reference's shadow any-hit: the contract of the port's K8 (a ray is
blocked when some triangle of the scene passes K8's float32
Moller-Trumbore test with its alpha mask in (tmin, tmax)) computed with a
cull of its own, so that it takes a second and not hours at a million
triangles and rays.

The rays of a directional light are parallel. Projected along their
direction d onto a plane, a ray is a point and a triangle a 2-D triangle;
the ray can meet the triangle only where the point lies in the triangle's
2-D box, and only where the segment [tmin, tmax] overlaps the triangle's
extent along d. The plane is cut into square cells; each triangle is
listed in the cells its padded 2-D box covers, each live ray in the cell
of its point, and the pairs of a cell are joined. A pair that passes both
box tests (padded by 1e-3 plus 1e-5 of the coordinates' magnitude, far
beyond float32 rounding) is evaluated by K8's own pair test
(rt_cuda.any_hit_accepts, one pair at a time). None of the port's chunks,
lists or cull boxes is used.

The same join counts, for the roofline, the pairs whose axis-aligned
triangle box the ray segment meets (a float64 slab test on the boxes'
projected corners' cells). `record`, when a list, receives one dict per
call: triangles, live rays and those pairs.
"""
from __future__ import annotations

import torch

PAIR_BATCH = 1 << 23  # pairs evaluated at once
PAD_ABS = 1e-3
PAD_REL = 1e-5

record = None  # a list to append per-call counts to, or None


def _basis(d):
    """Two unit vectors spanning the plane orthogonal to unit d (float64)."""
    a = torch.tensor([1.0, 0.0, 0.0], dtype=d.dtype, device=d.device)
    if abs(float(d[0])) > 0.9:
        a = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device)
    u = torch.linalg.cross(d, a)
    u = u / u.norm()
    return u, torch.linalg.cross(d, u)


def any_hit_reference(scene, origins, dirs, tmin, tmax):
    """bool [R]: rt_cuda.any_hit's answer for rays [R, 3] / [R] whose
    directions are all equal (raises otherwise)."""
    from .rt_cuda import any_hit_accepts, prep_triangles
    dev = origins.device
    r = dirs.shape[0]
    tmin = tmin.expand(r) if tmin.dim() == 0 or tmin.shape[0] != r else tmin
    hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    live = tmax > tmin
    ray_id = torch.nonzero(live).squeeze(1)
    v0t, e1t, e2t, flags = prep_triangles(scene, True)
    flags = flags.clone()
    flags[0] = 1.0                       # both faces block shadow rays
    tri = torch.cat([v0t, e1t, e2t, flags]).T          # [Tp, 12]
    tri = tri[tri[:, 10] == 0.0].contiguous()          # drop padding
    n_tri = tri.shape[0]
    if ray_id.numel() == 0 or n_tri == 0:
        if record is not None:
            record.append({"triangles": n_tri, "rays": 0, "pairs": 0})
        return hit
    d32 = dirs[ray_id]
    if not bool((d32 == d32[0]).all()):
        raise NotImplementedError("the reference any-hit takes parallel "
                                  "rays only (a directional light)")
    d = d32[0].double()
    dn = d.norm()
    dh = d / dn
    u, v = _basis(dh)
    basis = torch.stack([u, v, dh])                    # [3, 3]

    o = origins[ray_id].double()
    ro = o @ basis.T                                   # [Rl, 3]: u, v, s
    s0 = ro[:, 2] + tmin[ray_id].double() * dn
    s1 = ro[:, 2] + tmax[ray_id].double() * dn

    v0 = tri[:, 0:3].double()
    verts = torch.stack([v0, v0 + tri[:, 3:6].double(),
                         v0 + tri[:, 6:9].double()], 1)  # [T, 3, 3]
    # the candidate region: the 2-D box of the triangle's axis-aligned
    # box's eight corners (it holds the triangle's own 2-D box)
    lo3, hi3 = verts.amin(1), verts.amax(1)
    corners = torch.stack([torch.where(torch.tensor(
        [(k >> a) & 1 for a in range(3)], device=dev, dtype=torch.bool),
        hi3, lo3) for k in range(8)], 1)               # [T, 8, 3]
    cp = corners @ basis.T
    tp = verts @ basis.T
    mag = tp.abs().amax((1, 2)).clamp(min=ro.abs().amax())
    pad = PAD_ABS + PAD_REL * mag
    blo, bhi = cp.amin(1), cp.amax(1)                  # [T, 3]
    tlo, thi = tp.amin(1) - pad[:, None], tp.amax(1) + pad[:, None]

    # cells: about one small triangle across
    ext = (tp.amax(1) - tp.amin(1))[:, :2].amax(-1)
    cell = float(ext.median().clamp(min=1e-3)) * 4.0
    umin = torch.minimum(blo[:, :2].amin(0), ro[:, :2].amin(0)) - 1.0
    gx = torch.floor((blo[:, 0] - umin[0]) / cell).long()
    gy = torch.floor((blo[:, 1] - umin[1]) / cell).long()
    hx = torch.floor((bhi[:, 0] - umin[0]) / cell).long()
    hy = torch.floor((bhi[:, 1] - umin[1]) / cell).long()
    ncol = int(torch.maximum(hx.amax(), torch.floor(
        (ro[:, 0] - umin[0]) / cell).long().amax())) + 1
    nx, ny = hx - gx + 1, hy - gy + 1
    cnt = nx * ny
    tidx = torch.repeat_interleave(torch.arange(n_tri, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(tidx.shape[0], device=dev) \
        - torch.repeat_interleave(first, cnt)
    cid = (gy[tidx] + torch.div(k, nx[tidx], rounding_mode="floor")) * ncol \
        + gx[tidx] + k % nx[tidx]
    cid, perm = torch.sort(cid)
    tidx = tidx[perm]
    rc = (torch.floor((ro[:, 1] - umin[1]) / cell).long() * ncol
          + torch.floor((ro[:, 0] - umin[0]) / cell).long())
    start = torch.searchsorted(cid, rc)
    n_per = torch.searchsorted(cid, rc, right=True) - start

    pairs = 0
    rcsum = torch.cumsum(n_per, 0)
    a = 0
    n_live = ray_id.shape[0]
    while a < n_live:
        base = rcsum[a - 1] if a else rcsum.new_zeros(())
        b = int(torch.searchsorted(rcsum, base + PAIR_BATCH, right=True))
        b = max(b, a + 1)
        rr = torch.repeat_interleave(torch.arange(a, b, device=dev),
                                     n_per[a:b])
        off = torch.arange(rr.shape[0], device=dev) \
            - torch.repeat_interleave(torch.cumsum(n_per[a:b], 0)
                                      - n_per[a:b], n_per[a:b])
        tt = tidx[start[rr] + off]
        p = ro[rr]
        # pairs whose triangle box the segment meets (float64 slab test)
        og = o[rr]
        inv = 1.0 / torch.where(dh.abs() < 1e-300, 1e-300, dh)
        ta = (lo3[tt] - og) * inv
        tb = (hi3[tt] - og) * inv
        tn = torch.maximum(torch.minimum(ta, tb).amax(-1),
                           (s0[rr] - p[:, 2]))
        tf = torch.minimum(torch.maximum(ta, tb).amin(-1),
                           (s1[rr] - p[:, 2]))
        pairs += int((tn <= tf).sum())
        # candidates for K8's pair test
        ok = ((p[:, 0] >= tlo[tt, 0]) & (p[:, 0] <= thi[tt, 0])
              & (p[:, 1] >= tlo[tt, 1]) & (p[:, 1] <= thi[tt, 1])
              & (s1[rr] + pad[tt] >= tlo[tt, 2])
              & (s0[rr] - pad[tt] <= thi[tt, 2]))
        rr, tt = rr[ok], tt[ok]
        gid = ray_id[rr]
        ray = torch.stack([origins[gid, 0], origins[gid, 1], origins[gid, 2],
                           dirs[gid, 0], dirs[gid, 1], dirs[gid, 2],
                           tmin[gid], tmax[gid]])[:, :, None]
        acc = any_hit_accepts(tri[tt][:, :, None], ray).reshape(-1)
        hit[gid[acc]] = True
        a = b
    if record is not None:
        record.append({"triangles": n_tri, "rays": n_live, "pairs": pairs})
    return hit
