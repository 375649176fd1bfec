"""What the reference keeps from the port's ops/raster_cuda.py (counterpart
of rtsdm_tpu/ops/raster_pallas.py): the screen-morton order of triangles
(the raster's tie order), K1's float32 fragment test, which
ops/ref_raster.py evaluates on the pairs its own cull keeps, and K2's
attribute table and fetch in their plain versions. The port's kernel
wrappers, chunk lists, cull boxes and the stochastic-depth raster (K9) are
not in this copy.
"""
from __future__ import annotations

import torch




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


def _check(t, dtype, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check(tri_id, torch.int32, "tri_id")
    _check(bary, torch.float32, "bary")
    _check(table, torch.float32, "table")
    if table.shape[1] != 3 * nci + nflat or bary.shape != tri_id.shape + (2,):
        raise ValueError("fetch_attributes: inconsistent shapes")
    return fetch_attributes_plain(tri_id, bary, table, nci, nflat)


def fetch_attributes_plain(tri_id, bary, table, nci: int, nflat: int):
    """Plain PyTorch version of K2."""
    from .raster import flat_fetch, interpolate
    t = table.shape[0]
    vert = table[:, :3 * nci].reshape(t, nci, 3).transpose(1, 2)  # [T,3,nci]
    flat = flat_fetch(tri_id, table[:, 3 * nci:])
    flat = torch.where((tri_id >= 0)[..., None], flat, 0.0)
    return torch.cat([interpolate(tri_id, bary, vert), flat], -1)
