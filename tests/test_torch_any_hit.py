"""The plain version of the shadow-ray any-hit kernel (K8,
rtsdm_tpu_torch/ops/rt_cuda.py) and the RayShadow pass against rtsdm_tpu on
the CPU.

The reference has two any-hit paths that disagree on alpha: on an
accelerator RayShadow calls any_hit_pallas (alpha test on, both faces
block, the unnormalized face test of _classic_origin_math); on the CPU it
calls rt.any_hit (no alpha test, normalized Moller-Trumbore). The port
follows the accelerator path in its kernel and its plain version, so both
are held against any_hit_pallas in interpret mode, and the whole pass
against the reference RayShadow driven through its Pallas branch (jax's
device list patched to report an accelerator, interpret mode on). The
reference's Pallas trace runs under jit here, where XLA:CPU may contract
a*b+c into fused multiply-adds; the hits still agree exactly on these
inputs (stated per test).
"""
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
from test_pallas_interpret import interpret_mode  # noqa: E402
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.ops import rt_pallas as rp  # noqa: E402
from rtsdm_tpu.passes.lighting import RayShadow as RayShadowJ  # noqa: E402
from rtsdm_tpu.rendergraph.render_pass import \
    RenderContext as RCJ  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu.utils.structs import replace  # noqa: E402
from rtsdm_tpu_torch.ops import rt_cuda as RT  # noqa: E402
from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer  # noqa: E402
from rtsdm_tpu_torch.passes.lighting import RayShadow  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402

FAKE_ACCELERATOR = [type("D", (), {"platform": "tpu"})()]


@pytest.fixture(scope="module")
def masked_arcade():
    """Arcade@small with every material alpha-tested and a random 4x4
    coverage mask on every triangle."""
    sj = PJ.arcade()
    rng = np.random.default_rng(23)
    m = sj.mat_alpha_mode.shape[0]
    return replace(sj, mat_alpha_mode=jnp.ones((m,), jnp.int32),
                   tri_alpha_mask=jnp.asarray(rng.integers(
                       0, 1 << 16, sj.num_triangles).astype(np.int32)))


def test_any_hit_plain_equals_any_hit_pallas(masked_arcade):
    """Per-ray origins inside the scene box, random directions, 15% dead
    rays (tmax = -1): K8's plain version (through the port's any_hit) and
    any_hit_pallas give the same hit for every ray (measured: 0 of 2048
    differ)."""
    sj = masked_arcade
    rng = np.random.default_rng(17)
    n = 2048
    pts = np.asarray(sj.positions.reshape(-1, 3))
    origins = rng.uniform(pts.min(0), pts.max(0), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full((n,), 1e-3, np.float32)
    tmax = rng.uniform(0.5, 60.0, n).astype(np.float32)
    tmax[rng.random(n) < 0.15] = -1.0
    with interpret_mode(rp):
        want = np.asarray(rp.any_hit_pallas(
            sj, *map(jnp.asarray, (origins, d, tmin, tmax))))
    st = carry(sj)
    got = RT.any_hit(st, *map(torch.as_tensor, (origins, d, tmin, tmax)))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)
    # the alpha test is on: with every mask cleared nothing blocks
    clear = RT.any_hit(
        carry(replace(sj, tri_alpha_mask=jnp.zeros_like(sj.tri_alpha_mask))),
        *map(torch.as_tensor, (origins, d, tmin, tmax)))
    assert not clear.any()


def test_any_hit_walk_stops_when_tile_is_done(masked_arcade):
    """The plain version's pair count: a ray stops at its first hit, a tile
    stops once its live rays have all hit (so it walks at most its list),
    and a tile of dead rays tests nothing."""
    st = carry(masked_arcade)
    n = 2 * RT.RB
    pts = st.positions.reshape(-1, 3)
    centre = (pts.amin(0) + pts.amax(0)) * 0.5
    origins = centre.expand(n, 3).contiguous()
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3).contiguous()
    tmin = torch.full((n,), 1e-3)
    tmax = torch.cat([torch.full((RB := RT.RB,), 1e4), torch.full((RB,),
                                                                 -1.0)])
    tri, boxes, lists, counts, rays = RT.any_hit_inputs(st, origins, d,
                                                       tmin, tmax)
    hit, pairs = RT.any_hit_blocks(tri, boxes, lists, counts, rays)
    assert bool(hit[:RB].all()) and not bool(hit[RB:].any())
    # identical rays meet their first occluder at the same pair
    assert bool((pairs[:RB] == pairs[0]).all())
    assert 0 < int(pairs[0]) <= int(counts[0]) * RT.TC
    assert not bool(pairs[RB:].any())


@pytest.mark.parametrize("name,w,h", [("Arcade", 64, 36),
                                      ("CornellBox", 48, 48)])
def test_ray_shadow_pass_matches_reference(name, w, h):
    """RayShadow, directional (Arcade) and point (CornellBox) light, on the
    same G-buffer (the port's, carried to both): the visibility planes
    agree on every pixel (measured: 0 differ)."""
    sj = PJ.load_scene(name, aspect=w / h)
    st = carry(sj)
    g = raster_gbuffer(st, w, h)
    pj = RayShadowJ({})
    pj.set_scene(sj)
    with interpret_mode(rp), mock.patch.object(
            jax, "devices", lambda *a, **k: FAKE_ACCELERATOR):
        want, _ = pj.execute(RCJ(width=w, height=h, scene=sj),
                             {"posW": jnp.asarray(g["posW"].numpy()),
                              "normalW": jnp.asarray(g["normW"].numpy())})
    want = np.asarray(want["visibility"])
    pt = RayShadow({})
    pt.set_scene(st)
    got, _ = pt.execute(RenderContext(width=w, height=h, scene=st),
                        {"posW": g["posW"], "normalW": g["normW"]})
    got = got["visibility"].numpy()
    assert got.shape == want.shape == (1, h, w)
    assert (got == 0.0).any() and (got == 1.0).any()
    np.testing.assert_array_equal(got, want)


def _all_pairs(tri, boxes, rays):
    """For every live ray and every chunk: K8's pair test on each of the
    chunk's triangles [n, R, TC] and K8's slab test against each of its
    boxes [n, R, N_CULL] (every pair, not only those a walk reaches)."""
    n = tri.shape[0]
    live = rays[7] > rays[6]
    ray = rays[:, live]
    acc = RT.any_hit_accepts(tri, ray[:, None].expand(8, n, ray.shape[1]))
    o, inv, flat, tmin, tmax = RT.slab_rows(ray)
    meets = RT.segment_overlaps(
        *(a[:, None, :, None] for a in (o, inv, flat)), tmin[None, :, None],
        tmax[None, :, None], [boxes[:, c, None, :] for c in range(3)],
        [boxes[:, 3 + c, None, :] for c in range(3)])
    return acc, meets


def _hold_cull(st, origins, dirs, tmin, tmax):
    """K8's cull on one call's rays: no box that a ray's segment misses
    holds a triangle the pair test accepts for that ray, and the plain
    version with the cull finds the hits of the plain version without it
    (and tests no more pairs). Returns (accepted pairs, share of (ray,
    box) pairs that meet)."""
    tri, boxes, lists, counts, rays = RT.any_hit_inputs(st, origins, dirs,
                                                        tmin, tmax)
    acc, meets = _all_pairs(tri, boxes, rays)
    n, r = acc.shape[:2]
    outside = acc.reshape(n, r, RT.N_CULL, RT.CULL_SUB) & ~meets[..., None]
    assert not bool(outside.any()), int(outside.sum())
    hit, pairs = RT.any_hit_blocks_plain(tri, boxes, lists, counts, rays)
    hit_f, pairs_f = RT.any_hit_blocks_plain(tri, None, lists, counts, rays)
    assert torch.equal(hit, hit_f)
    assert bool((pairs <= pairs_f).all())
    return int(acc.sum()), float(meets.float().mean())


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_cull_keeps_every_hit_on_masked_arcade(masked_arcade):
    """Masked Arcade, origins inside the scene box, 15% dead rays: one
    call per direction set (the sun's, an axis, zero and denormal
    components, random directions). With the sun's direction the boxes
    are tight (most (ray, box) pairs culled); along an axis the walls lie
    in the rays' planes and their boxes cover everything, as with random
    directions."""
    st = carry(masked_arcade)
    rng = np.random.default_rng(5)
    n = 1024
    pts = st.positions.reshape(-1, 3).numpy()
    origins = torch.as_tensor(rng.uniform(pts.min(0), pts.max(0), (n, 3))
                              .astype(np.float32))
    tmin = torch.full((n,), 1e-3)
    tmax = torch.as_tensor(rng.uniform(0.5, 60.0, n).astype(np.float32))
    tmax[torch.as_tensor(rng.random(n) < 0.15)] = -1.0
    shares = {}
    for name, d in (("sun", [-0.36, 0.89, 0.27]), ("axis", [0.0, 1.0, 0.0]),
                    ("denormal", [1e-40, 1.0, -1e-39]),
                    ("random", _unit(rng.normal(size=(n, 3))))):
        dirs = torch.as_tensor(np.broadcast_to(
            np.asarray(d, np.float32), (n, 3)).copy())
        accepted, shares[name] = _hold_cull(st, origins, dirs, tmin, tmax)
        assert accepted > 0, name
    assert shares["sun"] < 0.5


def _adversarial_scene():
    """Axis-aligned quads, a tilted plane tiled with small coplanar
    triangles, near-degenerate slivers (a vertex 1e-6 off the opposite
    edge), exactly collinear ones, tiny and large triangles; half the
    materials single-sided (back faces still block: K8 accepts both)."""
    from rtsdm_tpu_torch.scene.scene import make_scene
    rng = np.random.default_rng(11)
    tris = []
    for y in (0.0, 1.0):                          # two floors, quads
        tris += [[(-2, y, -2), (2, y, -2), (2, y, 2)],
                 [(-2, y, -2), (2, y, 2), (-2, y, 2)]]
    tris += [[(2, -2, -2), (2, 2, -2), (2, 2, 2)],    # a wall x = 2
             [(2, -2, -2), (2, 2, 2), (2, -2, 2)]]
    u, v = _unit([1.0, 0.2, 0.1]), _unit([-0.1, 0.3, 1.0])
    base = np.array([-1.5, 0.3, -1.5], np.float32)
    for i in range(6):                            # a tilted tiled plane
        for j in range(6):
            p = base + 0.5 * i * u + 0.5 * j * v
            tris += [[p, p + 0.5 * u, p + 0.5 * v],
                     [p + 0.5 * u, p + 0.5 * u + 0.5 * v, p + 0.5 * v]]
    for _ in range(40):                           # slivers
        p = rng.uniform(-1.8, 1.8, 3)
        e = rng.normal(size=3)
        off = np.cross(e, rng.normal(size=3))
        off *= 1e-6 / np.linalg.norm(off)
        tris.append([p, p + e, p + 0.5 * e + off])
    for _ in range(8):                            # exactly collinear
        p = rng.uniform(-1.8, 1.8, 3)
        tris.append([p, p + [0.5, 0.25, 0.0], p + [1.0, 0.5, 0.0]])
    for _ in range(40):                           # tiny
        p = rng.uniform(-1.8, 1.8, 3)
        tris.append([p, p + rng.normal(size=3) * 1e-4,
                     p + rng.normal(size=3) * 1e-4])
    for _ in range(6):                            # large
        tris.append(rng.uniform(-3.0, 3.0, (3, 3)))
    pos = np.asarray(tris, np.float32)
    mats = [dict(base_color=(0.5, 0.5, 0.5)),
            dict(base_color=(0.5, 0.5, 0.5), double_sided=True)]
    mid = (np.arange(pos.shape[0]) % 2).astype(np.int32)
    return make_scene("Adversarial", pos, material_id=mid, materials=mats,
                      device="cpu")


def test_cull_never_drops_an_accepted_pair_on_adversarial_rays():
    """The adversarial scene against rays that stress the cull's bound and
    the slab test, one call per set: grazing the floors (1e-4 and 1e-5
    rad) from 1e-5, 1e-7 and one ulp above them; straight down with tmax
    ending exactly on a floor (a box face) and one ulp past it; along the
    wall's plane x = 2 (two zero components, a flat axis); denormal
    components; along the tilted plane, from above it and
    from points on it (where the pair test accepts on rounding noise:
    boxes without the padding lose such pairs); random. Every pair the
    pair test accepts lies in a box its ray's segment meets."""
    st = _adversarial_scene()
    rng = np.random.default_rng(13)
    n = 512
    xz = rng.uniform(-1.9, 1.9, (n, 2)).astype(np.float32)

    def at_y(y):
        return torch.as_tensor(np.stack([xz[:, 0], np.full(n, y), xz[:, 1]],
                                        -1).astype(np.float32))

    tmin = torch.full((n,), 1e-4)
    tilt_u, tilt_v = _unit([1.0, 0.2, 0.1]), _unit([-0.1, 0.3, 1.0])
    ab = rng.uniform(0.2, 2.8, (n, 2)).astype(np.float32)
    on_tilt = torch.as_tensor((np.array([-1.5, 0.3, -1.5], np.float32)
                               + ab[:, :1] * tilt_u + ab[:, 1:] * tilt_v)
                              .astype(np.float32))
    cases = {
        "grazing": (at_y(1e-5), _unit([1.0, 1e-4, 0.3]),
                    rng.uniform(0.5, 6.0, n)),
        "grazing_closer": (at_y(1e-7), _unit([1.0, 1e-4, 0.3]),
                           rng.uniform(0.5, 6.0, n)),
        "grazing_above_one": (at_y(np.nextafter(np.float32(1.0),
                                                np.float32(2.0))),
                              _unit([1.0, 1e-5, -0.3]),
                              rng.uniform(0.5, 6.0, n)),
        "down_to_the_face": (at_y(1.0 + 0.5), [0.0, -1.0, 0.0],
                             np.full(n, 0.5)),
        "down_past_the_face": (at_y(1.0 + 0.5), [0.0, -1.0, 0.0],
                               np.full(n, np.nextafter(np.float32(1.5),
                                                       np.float32(2.0)))),
        "in_the_wall": (torch.as_tensor(np.stack(
            [np.full(n, 2.0), xz[:, 0], xz[:, 1]], -1).astype(np.float32)),
            [0.0, 0.0, 1.0], rng.uniform(0.5, 6.0, n)),
        "denormal": (at_y(1.5), [1e-40, -1.0, -1e-39],
                     rng.uniform(0.5, 6.0, n)),
        "along_tilt": (at_y(0.3), _unit([1.0, 0.2, 0.1]),
                       rng.uniform(0.5, 6.0, n)),
        # origins on the tilted plane (up to float32 rounding), directions
        # in it: the pair test's values are rounding noise there
        "in_the_tilt": (on_tilt, _unit([1.0, 0.2, 0.1]), np.full(n, 3.0)),
        "in_the_tilt_diagonal": (on_tilt, _unit(tilt_u + tilt_v),
                                 np.full(n, 3.0)),
        "random": (torch.as_tensor(rng.uniform(-1.9, 1.9, (n, 3))
                                   .astype(np.float32)),
                   _unit(rng.normal(size=(n, 3))), rng.uniform(0.5, 6.0, n)),
    }
    total = 0
    for name, (o, d, tmax) in cases.items():
        dirs = torch.as_tensor(np.broadcast_to(
            np.asarray(d, np.float32), (n, 3)).copy())
        tmax = torch.as_tensor(np.asarray(tmax, np.float32))
        accepted, _ = _hold_cull(st, o, dirs, tmin, tmax)
        total += accepted
    assert total > 0
