"""Triangle rasterizer (counterpart of rtsdm_tpu/ops/raster.py).

Homogeneous 2-D edge functions (no near-plane clipping stage; vertices
behind the camera are handled by sign logic) rasterized to a visibility
buffer (tri_id + perspective-correct barycentrics); attributes are fetched
afterwards. The raster itself is the sort-middle algorithm of
ops/raster_cuda.py at every triangle count: its CUDA kernel for CUDA
tensors, its plain version for CPU tensors; the k-slot stochastic-depth
raster (K9; counterpart of raster_pallas.raster_stochastic_pallas) walks the
same chunk lists: stochastic_planes, raster_stochastic_slots and
stochastic_depths, in that order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.profiler import profile_scope
from ..utils.math import cross, dot3, transform_point
from . import raster_cuda
from .rt_cuda import pad_tile

CULL_NONE = 0
CULL_BACK = 1
CULL_FRONT = 2

CULL_MODES = {"none": CULL_NONE, "back": CULL_BACK, "front": CULL_FRONT}


def _setup_triangles(view_proj, positions, width: int, height: int,
                     jitter_x, jitter_y, cull: int):
    """Per-triangle homogeneous setup.

    Returns (coef [T,5,3], bbox [T,4], valid [T]); coef rows are the edge
    functions c0, c1, c2 (E_i(p) = c_i . (px, py, 1)), the clip-z
    interpolant zc and the clip-w interpolant wc: z_ndc(p) = (zc.p)/(wc.p).
    """
    return _setup_with_w(view_proj, positions, width, height, jitter_x,
                         jitter_y, cull)[:3]


def _setup_with_w(view_proj, positions, width: int, height: int, jitter_x,
                  jitter_y, cull: int):
    """_setup_triangles' (coef, bbox, valid) and the vertices' clip w
    [T,3]."""
    clip = transform_point(view_proj, positions)           # [T,3,4]
    x, y, z, w = clip.unbind(-1)
    # homogeneous pixel coords; jitter shifts the image by (+jitterX,
    # -jitterY) pixels * dim, matching computeRayPinhole (Camera.slang:72-74)
    px = (x + w) * (0.5 * width) + (jitter_x * width) * w
    py = (w - y) * (0.5 * height) - (jitter_y * height) * w
    v = torch.stack([px, py, w], -1)                       # [T,3(vert),3]

    c0 = cross(v[:, 1], v[:, 2])
    c1 = cross(v[:, 2], v[:, 0])
    c2 = cross(v[:, 0], v[:, 1])
    det = dot3(c0, v[:, 0])
    # front face = world-CCW winding facing the camera, CW in y-down screen
    # space => det < 0
    if cull == CULL_BACK:
        valid = det < 0.0
        sgn = -torch.ones_like(det)
    elif cull == CULL_FRONT:
        valid = det > 0.0
        sgn = torch.ones_like(det)
    else:
        valid = det != 0.0
        sgn = torch.sign(det)
    # orient the edge functions so "inside" is all-positive
    c0, c1, c2 = c0 * sgn[:, None], c1 * sgn[:, None], c2 * sgn[:, None]
    zc = c0 * z[:, 0:1] + c1 * z[:, 1:2] + c2 * z[:, 2:3]
    wc = c0 * w[:, 0:1] + c1 * w[:, 1:2] + c2 * w[:, 2:3]
    coef = torch.stack([c0, c1, c2, zc, wc], 1)             # [T,5,3]

    # conservative pixel bbox; triangles with a vertex behind the eye get
    # the full viewport
    safe_w = torch.clamp(w, min=1e-9)
    sx, sy = px / safe_w, py / safe_w
    behind = (w <= 1e-9).any(-1)
    x0 = torch.where(behind, 0.0, torch.clamp(
        torch.floor(sx.amin(-1)), 0, width))
    x1 = torch.where(behind, float(width), torch.clamp(
        torch.ceil(sx.amax(-1)) + 1, 0, width))
    y0 = torch.where(behind, 0.0, torch.clamp(
        torch.floor(sy.amin(-1)), 0, height))
    y1 = torch.where(behind, float(height), torch.clamp(
        torch.ceil(sy.amax(-1)) + 1, 0, height))
    bbox = torch.stack([x0, y0, x1, y1], -1)
    valid = valid & (x1 > x0) & (y1 > y0)
    return coef, bbox, valid, w


def _binned_chunks(view_proj, positions, width: int, height: int,
                   jitter_x, jitter_y, cull: str):
    """Triangles set up, morton-sorted, packed into coefficient chunks with
    their screen boxes beside them, and binned to 8x32 tiles: ((chunks,
    tri_boxes, lists, counts, nby, nbx), eye_culled), eye_culled the 0-d
    count of valid triangles left out as wholly behind the eye
    (raster_cuda.behind_eye).

    Every culled triangle has a vertex behind the eye, hence the whole
    viewport as its box and the viewport centre's morton key. Sorted behind
    the others of that key and taken out of the chunks' valid row, their
    boxes and the tile lists, they leave every chunk outside that key's
    group as it is without the cull, and every other triangle in its
    relative order, to which K1 breaks ties. Both matter: K1 accepts a
    near-degenerate triangle's fragments up to 20 pixels outside its box
    (PERF.md section 2), which a tile sees only where the box of the chunk
    holding the triangle overlaps it. Sorted last with the invalid ones
    instead, the culled triangles shift every later chunk's members, and
    K1's outputs moved at 6 of the 48 frames of the benchmark's orbit
    (emerald_720p.orbit, seed 1, on an H100)."""
    with profile_scope("geometry.raster_bins"):
        coef, bbox, valid, w = _setup_with_w(view_proj, positions, width,
                                             height, jitter_x, jitter_y,
                                             CULL_MODES[cull])
        nby = -(-height // raster_cuda.TILE_RH)
        nbx = -(-width // raster_cuda.TILE_RW)
        culled = valid & raster_cuda.behind_eye(
            coef, w, nbx * raster_cuda.TILE_RW, nby * raster_cuda.TILE_RH)
        del w
        order = raster_cuda.screen_morton_order(bbox, valid, width, height,
                                                last=culled)
        # rebound, so the unsorted copies are freed before the packing
        coef, bbox, live = coef[order], bbox[order], (valid & ~culled)[order]
        return _pack_bins(coef, bbox, live, order, nby, nbx), culled.sum()


def _pack_bins(coef, bbox, live, order, nby: int, nbx: int):
    """(chunks, tri_boxes, lists, counts, nby, nbx) of set-up triangles in
    the chunks' order (`order`: their original ids): the `live` ones enter
    the chunks' valid row, their cull boxes and the tile lists."""
    chunks = raster_cuda.pack_coef_chunks(coef, live, order)
    cbox = raster_cuda.chunk_screen_bboxes(bbox, live)
    tri_boxes = raster_cuda.pack_tri_boxes(raster_cuda.cull_boxes(
        coef, nbx * raster_cuda.TILE_RW, nby * raster_cuda.TILE_RH), live)
    lists, counts = raster_cuda.build_chunk_lists_2d(cbox, nby, nbx)
    return chunks, tri_boxes, lists, counts, nby, nbx


def rasterize(view_proj, positions, *, width: int, height: int,
              jitter_x=0.0, jitter_y=0.0, cull: str = "back",
              depth_floor=None, min_separation: float = 0.0):
    """Rasterize a triangle soup [T,3,3] to a visibility buffer.

    depth_floor: optional [H,W] linear view depth; fragments with view
    depth <= floor + min_separation are discarded (depth peeling).
    Returns dict: tri_id [H,W] int32 (-1 = background), bary [H,W,2]
    (b1, b2), depth [H,W] NDC z in [0,1] (1.0 at background), overflow
    (tiles whose chunk list hit its width and streamed every chunk — a
    diagnostic, never a correctness loss) and eye_culled (the triangles
    left out of the binning as wholly behind the eye); both 0-d device
    tensors, read without a sync of the frame."""
    (chunks, tri_boxes, lists, counts, nby, nbx), eye_culled = \
        _binned_chunks(view_proj, positions, width, height, jitter_x,
                       jitter_y, cull)
    floor = None
    if depth_floor is not None:   # padding pixels take no fragment
        floor = pad_tile(depth_floor.to(torch.float32), 3e38)[0].contiguous()
    z, tid, b1, b2 = raster_cuda.raster_blocks(chunks, tri_boxes, lists,
                                               counts, nby, nbx, floor=floor,
                                               min_separation=min_separation)
    crop = (slice(0, height), slice(0, width))
    return {"tri_id": tid[crop], "bary": torch.stack([b1[crop], b2[crop]], -1),
            "depth": z[crop],
            "overflow": torch.clamp(counts - lists.shape[1], min=0).sum(),
            "eye_culled": eye_culled}


def stochastic_planes(width: int, height: int, first_depth, ray_min,
                      ray_max, device):
    """K9's per-pixel inputs (first, ray_min, ray_max) padded to whole 8x32
    tiles: the padding takes no fragment (first 3e38, ray_max 0); an input
    that is None admits every fragment (first -3e38, ray_min 0, ray_max
    3e38)."""
    hp = -(-height // raster_cuda.TILE_RH) * raster_cuda.TILE_RH
    wp = -(-width // raster_cuda.TILE_RW) * raster_cuda.TILE_RW

    def per_pixel(a, fill, default):
        if a is None:
            return torch.full((hp, wp), default, device=device)
        return pad_tile(a.to(torch.float32), fill)[0].contiguous()

    return (per_pixel(first_depth, 3e38, -3e38), per_pixel(ray_min, 0.0, 0.0),
            per_pixel(ray_max, 0.0, 3e38))


def raster_stochastic_slots(view_proj, positions, planes, *, width: int,
                            height: int, k: int, alpha: float,
                            cull: str = "back"):
    """K9 over the [width, height] grid's chunk lists: [k, hp, wp] slot
    minima of linear view depth (raster_cuda.SD_EMPTY where empty) of the
    padded per-pixel inputs `planes` (stochastic_planes)."""
    (chunks, tri_boxes, lists, counts, nby, nbx), _ = _binned_chunks(
        view_proj, positions, width, height, 0.0, 0.0, cull)
    return raster_cuda.raster_stochastic_blocks(
        chunks, tri_boxes, lists, counts, nby, nbx, *planes, k, alpha)


def stochastic_depths(slots, width: int, height: int, far):
    """[k, hp, wp] K9 slots -> [height, width, k] linear depths, `far`
    where a slot stayed empty."""
    t = slots[:, :height, :width].permute(1, 2, 0)
    return torch.where(t >= 3e37, far, t)


def interpolate(tri_id, bary, vertex_attr):
    """Perspective-correct attribute fetch: vertex_attr [T,3,C] ->
    [H,W,C], 0 at background."""
    a = vertex_attr[torch.clamp(tri_id, min=0).long()]      # [H,W,3,C]
    b1, b2 = bary[..., 0:1], bary[..., 1:2]
    b0 = 1.0 - b1 - b2
    out = b0 * a[..., 0, :] + b1 * a[..., 1, :] + b2 * a[..., 2, :]
    return torch.where((tri_id >= 0)[..., None], out, 0.0)


def flat_fetch(tri_id, per_tri):
    """Per-triangle attribute at each pixel's winner (background rows hold
    triangle 0's value; callers mask on tri_id < 0)."""
    return per_tri[torch.clamp(tri_id, min=0).long()]


class AttrTable(NamedTuple):
    """K2's table of some attributes (raster_cuda.pack_attr_rows) and how
    its outputs split into channels: (width, or None for a [T] flat, and
    the dtype to cast to, or None) per attribute, in order."""
    rows: torch.Tensor
    nci: int
    nflat: int
    channels: tuple


def attr_table(interp=(), flats=()) -> AttrTable:
    """The AttrTable of interpolated ([T,3,C]) and flat ([T] / [T,C])
    attributes."""
    rows, nci, nflat = raster_cuda.pack_attr_rows(interp, flats)
    channels = tuple((a.shape[2], None) for a in interp) + tuple(
        (None if f.ndim == 1 else f.shape[1],
         None if f.is_floating_point() else f.dtype) for f in flats)
    return AttrTable(rows, nci, nflat, channels)


def fetch_vertex_attributes(tri_id, bary, interp=(), flats=(), table=None):
    """Materialize interpolated ([T,3,C] tables) and flat ([T] / [T,C])
    attributes for a winner image in one pass (K2). Returns the channels in
    order; every channel is 0 at background pixels; integer flats keep
    their dtype. `table`: their attr_table, where the caller keeps one
    (passes/gbuffer.attribute_table); built here otherwise."""
    if table is None:
        table = attr_table(interp, flats)
    out = raster_cuda.fetch_attributes(tri_id.contiguous(),
                                       bary.contiguous(), table.rows,
                                       table.nci, table.nflat)
    res, k = [], 0
    for width, dtype in table.channels:
        o = out[..., k] if width is None else out[..., k:k + width]
        res.append(o if dtype is None else o.to(dtype))
        k += 1 if width is None else width
    return res
