"""The reference's k-slot stochastic-depth raster: the contract of the
port's K9 (ops/raster_cuda.raster_stochastic_blocks_plain without a cull)
computed with ops/ref_raster.py's own cull, never the port's chunks, lists
or cull boxes.

K9 keeps, in each of the k slots of each SD texel, the least linear view
depth of the fragments that

* pass the coverage test: K1's fragment test (raster_cuda.fragments:
  edges within K1's tolerance, w > 0, 0 <= z <= 1, a valid triangle) with
  every edge value at or above 0, as the Pallas kernel tests them
  (raster_pallas.py:255-257);
* lie behind the first layer: view depth vd = wd / (e0 + e1 + e2), 1
  where the sum is 0, above first + 0.01;
* lie inside the texel's ray interval: ray_min 0 or vd >= ray_min, and
  ray_max not 0 (a texel no sample asked for) and vd <= ray_max;
* and are inserted into the slot: its bit is set in the fragment's
  stratified coverage mask (utils/sampling.coverage_mask_select), drawn
  from the int32 hash of the truncated pixel centre and the triangle's
  original index that the Pallas kernel computes (raster_pallas.py:
  272-283: wrapping multiplies, arithmetic shifts, floor mod of |hb| with
  |INT_MIN| wrapping). The hash of the XLA tier is another; the Pallas
  kernel's is the reference.

Every triangle K1's fragment test accepts somewhere is a candidate of
ref_raster's tile cull there (its margin covers K1's tolerance), and K9's
test is stricter, so the cull drops no fragment K9 keeps. Surviving (tile,
triangle) pairs are expanded to their 64 texels and evaluated in float32
with the same expressions as the port, so each depth is the one K9
computes and the slots, minima, agree bit for bit.

`ref_raster.record`, when a list, receives one dict per call, beside K1's
entries: K1's `triangles`, `pixels` and `coverages` at 0 (so the raster
roofline sums what it summed without this call), and this call's own
`sd_triangles`, `sd_texels`, `sd_coverages` (the fragments that pass the
coverage test), `sd_inserted` (those that also pass the first-layer and
interval tests) and `k`, which harness/roofline_raster_sd.py reads.
"""
from __future__ import annotations

import torch

from . import raster_cuda, ref_raster
from .rt_cuda import _wrap32, key15_of_hash
from ..utils.math import transform_point
from ..utils.sampling import coverage_mask_select

SD_EMPTY = 3e38   # an empty slot
GOLDEN = 0x9E3779B1


def fragment_draws(px, py, oid):
    """The fragment's two uniform draws (raster_pallas.py:272-283) from the
    int32 hash of the truncated pixel centre and the triangle's original
    index, evaluated in int64 with explicit 32-bit wrapping. px, py, oid:
    float32 of one shape. Returns float32 (rng, rng2) in [0, 1]."""
    oid_i = oid.to(torch.int64)
    hb = _wrap32(_wrap32(px.to(torch.int64) * 374761393)
                 ^ _wrap32(py.to(torch.int64) * 668265263)
                 ^ _wrap32(oid_i << 7))
    hb = _wrap32((hb ^ (hb >> 13)) * GOLDEN)
    hb = hb ^ (hb >> 16)
    rng = key15_of_hash(hb).to(torch.float32) * (1.0 / 32767.0)
    h2 = (hb ^ _wrap32(oid_i * GOLDEN)) ^ (hb >> 5)
    rng2 = key15_of_hash(h2).to(torch.float32) * (1.0 / 32767.0)
    return rng, rng2


def raster_stochastic_reference(view_proj, positions, far, *, width: int,
                                height: int, k: int, alpha: float,
                                first_depth=None, ray_min=None, ray_max=None,
                                cull: str = "back"):
    """K9's slots as LINEAR view depths [height, width, k], `far` where a
    slot stayed empty (the port's ops/raster.stochastic_depths of
    raster_stochastic_slots).
    first_depth / ray_min / ray_max: optional [height, width] first-layer
    depth and ray interval (None: no floor, no interval)."""
    from .raster import CULL_MODES, _setup_triangles
    dev = positions.device
    coef, bbox, valid = _setup_triangles(view_proj, positions, width, height,
                                         0.0, 0.0, CULL_MODES[cull])
    w = transform_point(view_proj, positions)[..., 3]
    t = coef.shape[0]
    rows = torch.cat([coef.reshape(t, 15), valid.to(torch.float32)[:, None],
                      torch.arange(t, device=dev,
                                   dtype=torch.float32)[:, None]], 1)
    tri, ty, tx = ref_raster._candidates(coef, bbox, valid, w, width, height)

    def flat(a, default):
        if a is None:
            return torch.full((width * height,), default, device=dev)
        return a.to(torch.float32).reshape(-1)

    fi = flat(first_depth, -3e38) + 0.01
    rmn = flat(ray_min, 0.0)
    rmx = flat(ray_max, 3e38)
    slots = torch.full((k, width * height), SD_EMPTY, device=dev)
    tile = ref_raster.TILE
    pix_in_tile = torch.arange(tile * tile, device=dev)
    coverages = inserted = 0
    step = max(1, ref_raster.PAIR_BATCH // (tile * tile))
    for s in range(0, tri.shape[0], step):
        tr = tri[s:s + step]
        x = (tx[s:s + step, None] * tile + pix_in_tile % tile).reshape(-1)
        y = (ty[s:s + step, None] * tile + pix_in_tile // tile).reshape(-1)
        tr = tr[:, None].expand(-1, tile * tile).reshape(-1)
        inb = (x < width) & (y < height)
        x, y, tr = x[inb], y[inb], tr[inb]
        pix = y * width + x
        rt = rows[tr][:, :, None, None]
        xc, yc = x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5
        xf, yf = xc[:, None, None], yc[:, None, None]
        inside, _, e0, e1, e2 = raster_cuda.fragments(rt, xf, yf)
        wd = rt[:, 12] * xf + rt[:, 13] * yf + rt[:, 14]
        inside = inside & (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        esum = e0 + e1 + e2
        vd = (wd / torch.where(esum == 0.0, 1.0, esum)).reshape(-1)
        inside = inside.reshape(-1)
        coverages += int(inside.sum())
        rn, rx = rmn[pix], rmx[pix]
        inside = (inside & (vd > fi[pix]) & ((rn == 0.0) | (vd >= rn))
                  & (rx != 0.0) & (vd <= rx))
        inserted += int(inside.sum())
        pix, vd = pix[inside], vd[inside]
        rng, rng2 = fragment_draws(xc[inside], yc[inside],
                                   rows[tr[inside], 16])
        mask = coverage_mask_select(alpha, rng, rng2, k)
        for q in range(k):
            sel = ((mask >> q) & 1) > 0
            slots[q].scatter_reduce_(0, pix[sel], vd[sel], "amin")
    if ref_raster.record is not None:
        ref_raster.record.append({
            "triangles": 0, "pixels": 0, "coverages": 0,
            "sd_triangles": t, "sd_texels": width * height,
            "sd_coverages": coverages, "sd_inserted": inserted, "k": k})
    out = slots.T.reshape(height, width, k)
    return torch.where(out >= 3e37, far, out)
