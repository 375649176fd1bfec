"""Brute-force ray queries over the scene's triangle soup (counterpart of
rtsdm_tpu/ops/rt.py:36-203): the nearest hit (closest_hit, RTAO's rays)
and SVAO's Raytraced refinement query (vao_interval_query, reference
SVAO/Common.slang:679-713 and SVAORaster2.ps.slang:9-46).

Both are plain PyTorch, as the JAX package's were XLA code: Möller-Trumbore
on [pairs, rays, chunk] planes in the JAX package's operation order,
reduced over each chunk of triangles. The answer is the brute-force one,
every ray against every triangle; the work is cut without changing it:

* the rays are sorted by the Morton code of their segment's midpoint and
  taken in blocks of `ray_block`, so that a block's segments lie close
  together;
* a (block, chunk) pair is evaluated only where the box of the block's
  segments, [o + d tmin, o + d tmax] widened by PAD_REL of the scene's
  extent, meets the box of the chunk's vertices. A hit's point lies on
  the triangle and on the segment, so a pair whose boxes are apart has
  no hit;
* the results are order-free reductions (max and min of t; for the
  nearest hit, the least t and then the least triangle id, as the chunk
  scan with its first-index argmin gives), so the blocks and pairs may be
  taken in any order.

Functions take tensors on the scene's device; on a CUDA tensor they run
the same PyTorch operations on the card.
"""
from __future__ import annotations

import torch

DEFAULT_CHUNK = 256
CULL_NONE = 0
CULL_BACK = 1
EPS_DET = 1e-9
RAY_BLOCK = 256           # rays a block shares one segment box
PAD_REL = 1e-3            # box padding, a share of the scene's extent
PAIR_ELEMS = 1 << 23      # (pair, ray, triangle) lanes evaluated at once

_NO_KEY = (0x7F800000 << 32) | 0x7FFFFFFF   # key of (t = inf, id = max)


def _pad_tris(positions, chunk: int):
    """[T, 3, 3] -> ([Tp, 3, 3] with zero, never-hit triangles appended up
    to a multiple of `chunk`, n_chunks)."""
    t = positions.shape[0]
    pad = (-t) % chunk
    if pad:
        positions = torch.cat([positions, positions.new_zeros((pad, 3, 3))])
    return positions, (t + pad) // chunk


def _mt_intersect(o, d, v0, e1, e2, cull: int):
    """Möller-Trumbore on component tuples broadcast [..., R, 1] x
    [..., 1, K] -> (t, valid, front, (u, v)), each [..., R, K], in the
    JAX package's operation order (jnp.cross, then the 3-term sums)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det > EPS_DET if cull == CULL_BACK else torch.abs(det) > EPS_DET
    inv_det = 1.0 / torch.where(torch.abs(det) < EPS_DET, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid, det > 0.0, (u, v)


def _front_accept(flags, front, valid, bary_uv, alpha_test: bool):
    """aoAnyHit's face logic (SVAO/Common.slang:679-697): a front face, a
    double-sided or an alpha-tested material counts as front; an
    alpha-masked hit tests the baked per-triangle 4x4 coverage bitmap at
    its barycentric cell. flags = (accept any face [..., 1, K] bool, mask
    [..., 1, K] int32: 0xFFFF unless alpha-masked)."""
    accept_any, mask = flags
    ok = front | accept_any
    if alpha_test:
        u, v = bary_uv
        # lanes that miss are zeroed before the integer conversion (their
        # values are discarded anyway)
        u = torch.where(valid, u, 0.0)
        v = torch.where(valid, v, 0.0)
        cell = (torch.clamp(u * 4.0, 0.0, 3.0).to(torch.int32)
                + 4 * torch.clamp(v * 4.0, 0.0, 3.0).to(torch.int32))
        ok = ok & ((torch.bitwise_right_shift(mask, cell) & 1) > 0)
    return ok


def _morton3(p, lo, hi):
    """30-bit Morton codes (int64) of points [N, 3] in the box [lo, hi]."""
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-30) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
    code = torch.zeros_like(q[:, 0])
    for axis in range(3):
        x = q[:, axis]
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        code = code | (x << (2 - axis))
    return code


class _Soup:
    """A scene's triangles as padded component planes [n_chunks, chunk]
    and each chunk's vertex box, with the per-triangle face flags."""

    def __init__(self, scene, chunk: int):
        tris, n_chunks = _pad_tris(scene.positions, chunk)
        t = scene.positions.shape[0]
        self.chunk, self.n_chunks = chunk, n_chunks
        v0 = tris[:, 0]
        e1 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        self.v0, self.e1, self.e2 = (
            tuple(a[:, c].reshape(n_chunks, chunk) for c in range(3))
            for a in (v0, e1, e2))
        per_chunk = tris.reshape(n_chunks, chunk * 3, 3)
        if t % chunk:
            # the padding triangles sit at the origin: keep them out of the
            # last chunk's box
            n_last = (t % chunk) * 3
            last = per_chunk[-1, :n_last]
            lo = per_chunk.amin(1)
            hi = per_chunk.amax(1)
            lo[-1], hi[-1] = last.amin(0), last.amax(0)
        else:
            lo, hi = per_chunk.amin(1), per_chunk.amax(1)
        self.box_lo, self.box_hi = lo, hi
        pos = scene.positions
        self.extent = float((pos.amax((0, 1)) - pos.amin((0, 1))).max()) \
            if t else 1.0
        mid = scene.material_id.long()
        is_alpha = scene.mat_alpha_mode[mid] == 1
        accept = scene.mat_double_sided[mid] | is_alpha
        mask = torch.where(is_alpha, scene.tri_alpha_mask.to(torch.int32),
                           0xFFFF).to(torch.int32)
        pad = n_chunks * chunk - t
        self.accept_any = torch.nn.functional.pad(
            accept, (0, pad)).reshape(n_chunks, chunk)
        self.mask = torch.nn.functional.pad(
            mask, (0, pad), value=0xFFFF).reshape(n_chunks, chunk)
        self.real = (torch.arange(n_chunks * chunk, device=pos.device)
                     < t).reshape(n_chunks, chunk)


def _pairs(soup, origins, dirs, tmin, tmax, ray_block: int):
    """Sort the rays into blocks and list the (block, chunk) pairs whose
    boxes meet. Returns (order [nb * B] ray index or -1 for padding,
    per-block ray planes, pairs [n, 2])."""
    dev = origins.device
    r = origins.shape[0]
    live = tmax > tmin
    t0 = torch.where(live, tmin, 0.0)
    t1 = torch.where(live, tmax, 0.0)
    p0 = origins + dirs * t0[:, None]
    p1 = origins + dirs * t1[:, None]
    big = torch.full_like(p0, float("inf"))
    # an unbounded segment (0 * inf = nan) spans every box
    inf = float("inf")
    seg_lo = torch.nan_to_num(
        torch.where(live[:, None], torch.minimum(p0, p1), big), nan=-inf,
        posinf=inf, neginf=-inf)
    seg_hi = torch.nan_to_num(
        torch.where(live[:, None], torch.maximum(p0, p1), -big), nan=inf,
        posinf=inf, neginf=-inf)
    finite = torch.isfinite(seg_lo).all(1) & torch.isfinite(seg_hi).all(1)
    mid = torch.where(finite[:, None], 0.5 * (seg_lo + seg_hi), 0.0)
    if bool(finite.any()):
        lo = mid[finite].amin(0)
        hi = mid[finite].amax(0)
    else:
        lo = hi = torch.zeros(3, device=dev)
    order = torch.argsort(_morton3(mid, lo, hi), stable=True)
    nb = -(-r // ray_block)
    pad = nb * ray_block - r
    order = torch.cat([order, order.new_full((pad,), -1)])
    sel = torch.clamp(order, min=0)
    in_ray = order >= 0

    def blocks(a, fill):
        a = torch.where(in_ray.reshape((-1,) + (1,) * (a.ndim - 1)),
                        a[sel], fill)
        return a.reshape((nb, ray_block) + a.shape[1:])

    pad_box = PAD_REL * soup.extent + 1e-6
    blo = blocks(seg_lo, float("inf")).amin(1) - pad_box
    bhi = blocks(seg_hi, -float("inf")).amax(1) + pad_box
    meet = ((blo[:, None] <= soup.box_hi[None])
            & (soup.box_lo[None] <= bhi[:, None])).all(-1)
    pairs = torch.nonzero(meet)
    rays = dict(o=blocks(origins, 0.0), d=blocks(dirs, 0.0),
                tmin=blocks(tmin, 0.0), tmax=blocks(tmax, -1.0))
    return order, rays, pairs


def _pair_batches(soup, rays, pairs, ray_block: int):
    """Yield (block ids [P], ray component tuples [P, B, 1], the chunks'
    triangle planes [P, 1, K], their ids [P, 1, K]) for batches of pairs."""
    per = max(1, PAIR_ELEMS // (ray_block * soup.chunk))
    for s in range(0, pairs.shape[0], per):
        b = pairs[s:s + per, 0]
        c = pairs[s:s + per, 1]
        o = tuple(rays["o"][b, :, k, None] for k in range(3))
        d = tuple(rays["d"][b, :, k, None] for k in range(3))
        tri = [tuple(a[c][:, None, :] for a in plane)
               for plane in (soup.v0, soup.e1, soup.e2)]
        ids = (c[:, None] * soup.chunk
               + torch.arange(soup.chunk, device=c.device))[:, None, :]
        yield b, c, o, d, tri, ids


def closest_hit(scene, origins, dirs, tmin, tmax, chunk: int = DEFAULT_CHUNK,
                cull: int = CULL_NONE, ray_block: int = RAY_BLOCK):
    """Nearest intersection in (tmin, tmax): (t, tri_id), t = tmax and id
    -1 on a miss. Ties go to the least triangle id. origins, dirs [R, 3];
    tmin, tmax [R]."""
    r = origins.shape[0]
    dev = origins.device
    soup = _Soup(scene, chunk)
    order, rays, pairs = _pairs(soup, origins, dirs, tmin, tmax, ray_block)
    nb = rays["tmin"].shape[0]
    keys = torch.full((nb * ray_block,), _NO_KEY, dtype=torch.int64,
                      device=dev)
    for b, c, o, d, tri, ids in _pair_batches(soup, rays, pairs, ray_block):
        t, valid, _, _ = _mt_intersect(o, d, *tri, cull)
        tn = rays["tmin"][b][..., None]
        tx = rays["tmax"][b][..., None]
        t = torch.where(valid & soup.real[c][:, None, :] & (t > tn)
                        & (t < tx), t, float("inf"))
        k = torch.argmin(t, dim=2)                      # first least t
        tk = torch.gather(t, 2, k[..., None])[..., 0]
        idk = torch.gather(ids.expand_as(t), 2, k[..., None])[..., 0]
        bits = tk.view(torch.int32).to(torch.int64)
        # t > tmin may be negative: order the float bits as integers
        bits = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
        key = torch.where(torch.isinf(tk), _NO_KEY, (bits << 32) | idk)
        flat = (b[:, None] * ray_block
                + torch.arange(ray_block, device=dev)).reshape(-1)
        keys.scatter_reduce_(0, flat, key.reshape(-1), "amin")
    hit = keys != _NO_KEY
    bits = keys >> 32
    bits = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int32)
    t_blk = bits.view(torch.float32)
    tid_blk = torch.where(hit, keys & 0xFFFFFFFF, -1).to(torch.int32)
    t = torch.empty(r, device=dev)
    tid = torch.empty(r, dtype=torch.int32, device=dev)
    live = order >= 0
    t[order[live]] = t_blk[live]
    tid[order[live]] = tid_blk[live]
    return torch.where(tid >= 0, t, tmax), tid


def vao_interval_query(scene, origins, dirs, tmin, tmax, t_sphere_start,
                       chunk: int = DEFAULT_CHUNK, cull: int = CULL_NONE,
                       alpha_test: bool = True, ray_block: int = RAY_BLOCK):
    """The VAO refinement ray (SVAO/Common.slang:699-713, traceAORay in
    SVAORaster2.ps.slang:9-46): over the front-accepted hits with t in
    (tmin, tmax),
      t_last_halo = max t with t <= t_sphere_start (the halo blocker),
      t_first_in  = min t with t >  t_sphere_start (inside the sphere),
    -inf and +inf where there is none. All inputs [R] or [R, 3]."""
    r = origins.shape[0]
    dev = origins.device
    soup = _Soup(scene, chunk)
    order, rays, pairs = _pairs(soup, origins, dirs, tmin, tmax, ray_block)
    nb = rays["tmin"].shape[0]
    ts_all = torch.cat([t_sphere_start, t_sphere_start.new_zeros(
        nb * ray_block - r)])[torch.clamp(order, min=0)] \
        .reshape(nb, ray_block)
    halo_out = torch.full((nb * ray_block,), -float("inf"), device=dev)
    in_out = torch.full((nb * ray_block,), float("inf"), device=dev)
    for b, c, o, d, tri, ids in _pair_batches(soup, rays, pairs, ray_block):
        t, valid, front, uv = _mt_intersect(o, d, *tri, cull)
        flags = (soup.accept_any[c][:, None, :], soup.mask[c][:, None, :])
        ok = valid & _front_accept(flags, front, valid, uv, alpha_test) \
            & soup.real[c][:, None, :]
        ok = ok & (t > rays["tmin"][b][..., None]) \
            & (t < rays["tmax"][b][..., None])
        ts = ts_all[b][..., None]
        halo = torch.where(ok & (t <= ts), t, -float("inf")).amax(2)
        inside = torch.where(ok & (t > ts), t, float("inf")).amin(2)
        flat = (b[:, None] * ray_block
                + torch.arange(ray_block, device=dev)).reshape(-1)
        halo_out.scatter_reduce_(0, flat, halo.reshape(-1), "amax")
        in_out.scatter_reduce_(0, flat, inside.reshape(-1), "amin")
    last_halo = torch.empty(r, device=dev)
    first_in = torch.empty(r, device=dev)
    live = order >= 0
    last_halo[order[live]] = halo_out[live]
    first_in[order[live]] = in_out[live]
    return last_halo, first_in


def query_tests(scene, origins, dirs, tmin, tmax, chunk: int = DEFAULT_CHUNK,
                ray_block: int = RAY_BLOCK):
    """(ray-triangle tests the culled query evaluates, tests a brute-force
    query would) for these rays: the work the queries above do."""
    soup = _Soup(scene, chunk)
    _, _, pairs = _pairs(soup, origins, dirs, tmin, tmax, ray_block)
    return (int(pairs.shape[0]) * ray_block * chunk,
            int(origins.shape[0]) * int(scene.positions.shape[0]))
