"""Procedural test scenes (counterpart of rtsdm_tpu/scene/procedural.py).

The reference media (Arcade, Sun Temple, Bistro, Emerald Square) are not
part of the repository; these deterministic numpy builders stand in for them
under the same names, with two detail tiers: "small" (box towns) and "full"
(reference-scale triangle counts dominated by alpha-masked foliage). The
builders are the reference package's, so both packages build identical
triangle soups; only the textures, lights and environment the port's Scene
does not carry are left out.
"""
from __future__ import annotations

import numpy as np

from .camera import Camera
from .scene import Scene, make_scene


def _quad(p0, p1, p2, p3):
    """Two CCW triangles for quad p0..p3 (wound so the normal faces the viewer
    of the CCW loop)."""
    return [[p0, p1, p2], [p0, p2, p3]]


def _box(bmin, bmax, inward=False):
    """12 triangles of an axis-aligned box; inward=True flips winding so
    normals point inside (room walls)."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    c = lambda x, y, z: (x, y, z)
    tris = []
    # +z face (front), viewed from +z: CCW
    tris += _quad(c(x0, y0, z1), c(x1, y0, z1), c(x1, y1, z1), c(x0, y1, z1))
    # -z face
    tris += _quad(c(x1, y0, z0), c(x0, y0, z0), c(x0, y1, z0), c(x1, y1, z0))
    # +x
    tris += _quad(c(x1, y0, z1), c(x1, y0, z0), c(x1, y1, z0), c(x1, y1, z1))
    # -x
    tris += _quad(c(x0, y0, z0), c(x0, y0, z1), c(x0, y1, z1), c(x0, y1, z0))
    # +y (top)
    tris += _quad(c(x0, y1, z1), c(x1, y1, z1), c(x1, y1, z0), c(x0, y1, z0))
    # -y (bottom)
    tris += _quad(c(x0, y0, z0), c(x1, y0, z0), c(x1, y0, z1), c(x0, y0, z1))
    t = np.array(tris, np.float32)
    if inward:
        t = t[:, ::-1, :]
    return t


def _rot_y(tris, angle, center):
    ca, sa = np.cos(angle), np.sin(angle)
    r = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
    return (tris - center) @ r.T + center


def cornell_box(aspect=1.0, device="cpu") -> Scene:
    """Procedural Cornell box (BASELINE.json config 1). 2m room, two blocks."""
    tris = []
    mats = []
    mat_ids = []

    def add(t, mid):
        tris.append(t)
        mat_ids.append(np.full((t.shape[0],), mid, np.int32))

    white = dict(base_color=(0.73, 0.73, 0.73), roughness=0.9)
    red = dict(base_color=(0.65, 0.05, 0.05), roughness=0.9)
    green = dict(base_color=(0.12, 0.45, 0.15), roughness=0.9)
    light_mat = dict(base_color=(0.78, 0.78, 0.78), emissive=(8.0, 8.0, 8.0))
    mats += [white, red, green, light_mat]

    s = 2.0  # room size in meters
    # room interior (normals inward; winding chosen so cross(p1-p0,p2-p0) faces in)
    floor = np.array(_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0)), np.float32)
    ceil = np.array(_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s)), np.float32)
    back = np.array(_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0)), np.float32)
    left = np.array(_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s)), np.float32)
    right = np.array(_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0)), np.float32)
    add(floor, 0)
    add(ceil, 0)
    add(back, 0)
    add(left, 1)
    add(right, 2)
    # light quad just below ceiling
    lq = np.array(_quad((0.8, s - 0.01, 0.8), (1.2, s - 0.01, 0.8),
                        (1.2, s - 0.01, 1.2), (0.8, s - 0.01, 1.2)), np.float32)
    add(lq, 3)
    # tall block
    tall = _box((0.25, 0.0, 0.25), (0.85, 1.2, 0.85))
    tall = _rot_y(tall, np.deg2rad(17.0), np.array([0.55, 0.0, 0.55], np.float32))
    add(tall, 0)
    # short block
    short = _box((1.15, 0.0, 0.9), (1.75, 0.6, 1.5))
    short = _rot_y(short, np.deg2rad(-18.0), np.array([1.45, 0.0, 1.2], np.float32))
    add(short, 0)

    positions = np.concatenate(tris, axis=0)
    material_id = np.concatenate(mat_ids, axis=0)

    cam = Camera.create(position=(1.0, 1.0, 4.4), target=(1.0, 1.0, 0.0),
                        up=(0.0, 1.0, 0.0), focal_length=35.0, aspect=aspect,
                        near_z=0.1, far_z=100.0, device=device)
    return make_scene("CornellBox", positions, material_id=material_id,
                      materials=mats, camera=cam, device=device)


def _tree_patch(rng, n_trees, leaves_per_tree, extent):
    """Instanced trees (vectorized): octagonal trunk prisms + canopies of
    randomly-oriented ALPHA-MASKED leaf quads — the procedural stand-in for
    the reference media's foliage (Bistro/Emerald Square), exercising the
    alpha-tested any-hit path (reference StochasticDepthMapRT.rt.slang:31-37,
    SVAO/Common.slang:689-692) at reference triangle counts.

    Returns (trunk_tris [Tt,3,3], leaf_tris [Tl,3,3])."""
    if n_trees == 0:
        return (np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.int32))
    cx = rng.uniform(-extent * 0.9, extent * 0.9, n_trees)
    cz = rng.uniform(-extent * 0.9, extent * 0.9, n_trees)
    th = rng.uniform(1.8, 4.5, n_trees)                     # trunk height
    tr = th * rng.uniform(0.04, 0.07, n_trees)              # trunk radius

    # trunks: 8-sided prisms, 16 tris each, fully vectorized
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], -1)         # [8,2]
    base = np.stack([cx[:, None] + tr[:, None] * ring[:, 0],
                     np.zeros((n_trees, 8)),
                     cz[:, None] + tr[:, None] * ring[:, 1]], -1)  # [N,8,3]
    top = base + np.stack([np.zeros(n_trees), th, np.zeros(n_trees)],
                          -1)[:, None, :]
    j = (np.arange(8) + 1) % 8
    quads = np.stack([base[:, j], base, top, top[:, j]], 2)  # [N,8,4,3]
    t1 = quads[:, :, (0, 1, 2)]
    t2 = quads[:, :, (0, 2, 3)]
    trunks = np.concatenate([t1, t2], 2).reshape(-1, 3, 3).astype(np.float32)

    # canopies: leaves_per_tree quads in an ellipsoid above the trunk
    n_leaf = n_trees * leaves_per_tree
    cr = th * rng.uniform(0.35, 0.55, n_trees)              # canopy radius
    u = rng.normal(size=(n_leaf, 3))
    u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-8)
    rad = cr.repeat(leaves_per_tree) * np.cbrt(rng.uniform(0.1, 1.0, n_leaf))
    centers = np.stack([cx.repeat(leaves_per_tree),
                        th.repeat(leaves_per_tree) * 1.05,
                        cz.repeat(leaves_per_tree)], -1) + u * rad[:, None]
    a = rng.normal(size=(n_leaf, 3))
    a /= np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-8)
    b = np.cross(u, a)
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-8)
    s = rng.uniform(0.10, 0.22, (n_leaf, 1))
    av, bv = a * s, b * s
    p0, p1 = centers - av - bv, centers + av - bv
    p2, p3 = centers + av + bv, centers - av + bv
    leaves = np.concatenate([np.stack([p0, p1, p2], 1),
                             np.stack([p0, p2, p3], 1)], 0).astype(np.float32)

    # alpha coverage: an elliptical leaf inscribed in the quad, baked as a
    # 4x4 bitmap per triangle over barycentric (u,v) (scene.tri_alpha_mask)
    def bake(quad_st):
        m = 0
        for j in range(4):
            for i in range(4):
                u, v = (i + 0.5) / 4.0, (j + 0.5) / 4.0
                sq, tq = quad_st(u, v)
                if sq * sq + tq * tq <= 1.0:
                    m |= 1 << (i + 4 * j)
        return m

    mask1 = bake(lambda u, v: (-1 + 2 * u + 2 * v, -1 + 2 * v))
    mask2 = bake(lambda u, v: (-1 + 2 * u, -1 + 2 * u + 2 * v))
    leaf_masks = np.concatenate([np.full(n_leaf, mask1, np.int32),
                                 np.full(n_leaf, mask2, np.int32)])
    return trunks, leaves, leaf_masks


def _box_map_uv(positions, scale=0.25):
    """Per-triangle box-mapped texcoords [T,3,2]: project each vertex onto
    the two axes orthogonal to the face normal's dominant axis (the
    triplanar uv the media scenes' unwraps stand in for)."""
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    n = np.abs(np.cross(e1, e2))
    axis = np.argmax(n, axis=-1)                        # [T]
    # uv axes per dominant axis: x->(y,z), y->(x,z), z->(x,y)
    ua = np.choose(axis, [1, 0, 0])
    va = np.choose(axis, [2, 2, 1])
    idx = np.arange(positions.shape[0])
    u = positions[idx[:, None], np.arange(3)[None, :], ua[:, None]]
    v = positions[idx[:, None], np.arange(3)[None, :], va[:, None]]
    return (np.stack([u, v], axis=-1) * scale).astype(np.float32)


def _town(name, seed, n_buildings, n_props, extent, aspect, cam_height=1.7,
          columns=0, trees=0, leaves_per_tree=0, device="cpu") -> Scene:
    """Deterministic box-town generator: ground plane + buildings + props
    (+ alpha-masked foliage at the reference-scale detail tier).

    Stand-in for the packman media scenes; complexity scales with the
    building/prop/tree counts so perf behaves like the staged eval configs.
    """
    rng = np.random.default_rng(seed)
    tris = [np.array(_quad((-extent, 0, -extent), (-extent, 0, extent),
                           (extent, 0, extent), (extent, 0, -extent)), np.float32)]
    mat_ids = [np.zeros((2,), np.int32)]
    mats = [dict(base_color=(0.45, 0.42, 0.38), roughness=0.95)]  # ground

    palette = [(0.7, 0.6, 0.5), (0.6, 0.65, 0.7), (0.75, 0.7, 0.6),
               (0.55, 0.5, 0.5), (0.65, 0.55, 0.45), (0.5, 0.6, 0.55)]
    for c in palette:
        mats.append(dict(base_color=c, roughness=0.8))

    def place_box(size_lo, size_hi):
        sx = rng.uniform(*size_lo)
        sy = rng.uniform(*size_hi)
        sz = rng.uniform(*size_lo)
        x = rng.uniform(-extent * 0.85, extent * 0.85)
        z = rng.uniform(-extent * 0.85, extent * 0.85)
        b = _box((x - sx / 2, 0.0, z - sz / 2), (x + sx / 2, sy, z + sz / 2))
        b = _rot_y(b, rng.uniform(0, np.pi / 2), np.array([x, 0, z], np.float32))
        return b

    for _ in range(n_buildings):
        b = place_box((2.0, 6.0), (2.5, 9.0))
        tris.append(b)
        mat_ids.append(np.full((12,), 1 + rng.integers(0, len(palette)), np.int32))
    for _ in range(n_props):
        b = place_box((0.3, 1.2), (0.3, 1.5))
        tris.append(b)
        mat_ids.append(np.full((12,), 1 + rng.integers(0, len(palette)), np.int32))
    # octagonal columns add curved-ish geometry (temple/arcade flavour)
    for _ in range(columns):
        x = rng.uniform(-extent * 0.6, extent * 0.6)
        z = rng.uniform(-extent * 0.6, extent * 0.6)
        r, h, n = rng.uniform(0.2, 0.5), rng.uniform(2.0, 5.0), 8
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pts0 = np.stack([x + r * np.cos(ang), np.zeros(n), z + r * np.sin(ang)], -1)
        pts1 = pts0 + np.array([0, h, 0], np.float32)
        quads = []
        for i in range(n):
            j = (i + 1) % n
            quads += _quad(tuple(pts0[j]), tuple(pts0[i]), tuple(pts1[i]), tuple(pts1[j]))
        tris.append(np.array(quads, np.float32))
        mat_ids.append(np.full((2 * n,), 1 + rng.integers(0, len(palette)), np.int32))

    alpha_masks = None
    if trees:
        trunk_mat = len(mats)
        mats.append(dict(base_color=(0.42, 0.30, 0.20), roughness=0.9))
        leaf_mat = len(mats)
        mats.append(dict(base_color=(0.20, 0.42, 0.16), roughness=0.8,
                         alpha_mode=1, opacity=0.75, double_sided=True))
        trunks, leaves, leaf_masks = _tree_patch(rng, trees, leaves_per_tree,
                                                 extent)
        n_before = sum(t.shape[0] for t in tris)
        tris += [trunks, leaves]
        mat_ids += [np.full((trunks.shape[0],), trunk_mat, np.int32),
                    np.full((leaves.shape[0],), leaf_mat, np.int32)]
        alpha_masks = np.concatenate([
            np.full(n_before + trunks.shape[0], 0xFFFF, np.int32),
            leaf_masks])

    positions = np.concatenate(tris, axis=0)
    material_id = np.concatenate(mat_ids, axis=0)

    cam = Camera.create(position=(-extent * 0.7, cam_height + 2.0, extent * 0.9),
                        target=(0.0, 1.0, 0.0), focal_length=21.0, aspect=aspect,
                        near_z=0.1, far_z=500.0, device=device)
    return make_scene(name, positions, material_id=material_id, materials=mats,
                      texcoords=_box_map_uv(positions), camera=cam,
                      tri_alpha_mask=alpha_masks, device=device)


# Two detail tiers per scene: "small" (the round-1 box-towns; what the CPU
# test suite uses) and "full" — reference-scale triangle counts in the class
# of the packman media (Sun Temple ~600k, Bistro ~3M per dependencies.xml
# provenance), dominated by alpha-masked foliage like the originals.

def arcade(aspect=16 / 9, detail="small", device="cpu"):
    t = dict(trees=180, leaves_per_tree=96) if detail == "full" else {}
    return _town("Arcade", seed=101, n_buildings=24, n_props=60, extent=18.0,
                 aspect=aspect, columns=10, device=device, **t)


def sun_temple(aspect=16 / 9, detail="small", device="cpu"):
    t = dict(trees=900, leaves_per_tree=170) if detail == "full" else {}
    return _town("SunTemple", seed=202, n_buildings=40, n_props=140, extent=30.0,
                 aspect=aspect, columns=40, device=device, **t)


def bistro(aspect=16 / 9, detail="small", device="cpu"):
    t = dict(trees=1800, leaves_per_tree=180) if detail == "full" else {}
    return _town("Bistro", seed=303, n_buildings=70, n_props=260, extent=45.0,
                 aspect=aspect, columns=50, device=device, **t)


def emerald_square(aspect=16 / 9, detail="small", device="cpu"):
    t = dict(trees=2600, leaves_per_tree=190) if detail == "full" else {}
    return _town("EmeraldSquare", seed=404, n_buildings=110, n_props=420,
                 extent=65.0, aspect=aspect, columns=60, device=device,
                 **t)


SCENES = {
    "CornellBox": cornell_box,
    "Arcade": arcade,
    "SunTemple": sun_temple,
    "Bistro": bistro,
    "EmeraldSquare": emerald_square,
}


def load_scene(name: str, aspect=1.0, detail: str = "small",
               device="cpu") -> Scene:
    """Scene factory by name (reference Mogwai m.loadScene). Suffix '@full'
    requests the reference-scale detail tier (e.g. 'SunTemple@full')."""
    base = name.split("/")[-1].split(".")[0]
    if "@" in base:
        base, detail = base.split("@", 1)
    if base == "CornellBox":
        return cornell_box(aspect=aspect, device=device)
    if base in SCENES:
        return SCENES[base](aspect=aspect, detail=detail, device=device)
    raise ValueError(f"unknown scene '{name}' (available: {list(SCENES)})")
