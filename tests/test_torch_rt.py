"""The brute-force ray queries of rtsdm_tpu_torch/ops/rt.py (closest_hit,
vao_interval_query) against rtsdm_tpu/ops/rt.py on the CPU: on CornellBox
with rays from its camera, and on a seeded triangle soup with opaque,
double-sided and alpha-masked materials (a random 4x4 coverage bitmap per
masked triangle), under both cull modes, with and without the alpha test,
with rays that have no interval or an unbounded one, and with more rays
than one ray block (the port's culled blocks).

Tolerances: triangle ids and the hit/miss pattern are exact; t within 16
ulp of max(|t|, 1) (the JAX package's jitted Möller-Trumbore contracts
multiply-adds on the CPU and the port rounds every operation, so the
error is absolute, of the size of the scene's coordinates, and grows on
grazing triangles: measured max 10).
"""
import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rtsdm_tpu.ops import rt as RJ  # noqa: E402
from rtsdm_tpu.scene.procedural import cornell_box  # noqa: E402
from rtsdm_tpu.scene.scene import make_scene  # noqa: E402
from rtsdm_tpu_torch.ops import rt  # noqa: E402
from test_torch_scene import carry  # noqa: E402

MAX_ULP = 16
N_RAYS = 700          # > 2 ray blocks of rt.RAY_BLOCK


def _soup_scene():
    rng = np.random.default_rng(21)
    n = 300
    centre = rng.uniform(-2.0, 2.0, (n, 1, 3))
    pos = (centre + rng.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    mats = [dict(), dict(double_sided=True), dict(alpha_mode=1)]
    mid = rng.integers(0, 3, n).astype(np.int32)
    mask = rng.integers(0, 1 << 16, n).astype(np.int32)
    return make_scene("soup", pos, material_id=mid, materials=mats,
                      tri_alpha_mask=mask)


def _soup_rays(n=N_RAYS, seed=22):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rng.uniform(0.0, 0.2, n).astype(np.float32)
    tmax = rng.uniform(0.5, 5.0, n).astype(np.float32)
    tmax[:20] = -1.0                 # no interval
    tmax[20:30] = np.inf             # unbounded
    ts = (tmin + rng.uniform(0.0, 1.0, n) * (np.minimum(tmax, 5.0) - tmin))
    return dict(o=o, d=d, tmin=tmin, tmax=tmax, ts=ts.astype(np.float32))


def _camera_rays(sj, w=40, h=30):
    """Rays from CornellBox's camera through a w x h grid of pixels, an
    interval around the middle of the room."""
    cam = sj.camera
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    o, d = cam.compute_ray_pinhole(jnp.asarray(pix), (w, h))
    d = np.array(d, np.float32)
    n = d.shape[0]
    rng = np.random.default_rng(23)
    tmin = rng.uniform(0.0, 2.0, n).astype(np.float32)
    tmax = (tmin + rng.uniform(0.5, 6.0, n)).astype(np.float32)
    ts = (tmin + rng.uniform(0.0, 1.0, n) * (tmax - tmin)).astype(np.float32)
    return dict(o=np.broadcast_to(np.asarray(o, np.float32), d.shape).copy(),
                d=d, tmin=tmin, tmax=tmax, ts=ts)


@pytest.fixture(scope="module")
def scenes():
    soup = _soup_scene()
    box = cornell_box()
    return {"soup": (soup, carry(soup), _soup_rays()),
            "cornell": (box, carry(box), _camera_rays(box))}


def _assert_t(got, want):
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)])
    f = np.isfinite(want)
    ulp = np.spacing(np.maximum(np.abs(want[f]), 1.0).astype(np.float32))
    assert (np.abs(got[f] - want[f]) <= MAX_ULP * ulp).all(), \
        (np.abs(got[f] - want[f]) / ulp).max()


@pytest.mark.parametrize("name", ["soup", "cornell"])
@pytest.mark.parametrize("cull", [rt.CULL_NONE, rt.CULL_BACK])
def test_closest_hit_matches_reference(scenes, name, cull):
    sj, st, r = scenes[name]
    chunk = 64 if name == "soup" else 16
    t_j, id_j = RJ.closest_hit(sj, jnp.asarray(r["o"]), jnp.asarray(r["d"]),
                               jnp.asarray(r["tmin"]), jnp.asarray(r["tmax"]),
                               chunk=chunk, cull=cull)
    t_t, id_t = rt.closest_hit(st, *(torch.as_tensor(r[k]) for k in
                                     ("o", "d", "tmin", "tmax")),
                               chunk=chunk, cull=cull)
    id_j = np.asarray(id_j)
    np.testing.assert_array_equal(id_t.numpy(), id_j)
    assert (id_j >= 0).sum() > 50 and (id_j < 0).any()
    _assert_t(t_t.numpy(), np.asarray(t_j))


@pytest.mark.parametrize("name", ["soup", "cornell"])
@pytest.mark.parametrize("cull,alpha_test", [
    (rt.CULL_NONE, True), (rt.CULL_BACK, True), (rt.CULL_NONE, False)])
def test_vao_interval_query_matches_reference(scenes, name, cull,
                                              alpha_test):
    sj, st, r = scenes[name]
    chunk = 64 if name == "soup" else 16
    keys = ("o", "d", "tmin", "tmax", "ts")
    want = RJ.vao_interval_query(sj, *(jnp.asarray(r[k]) for k in keys),
                                 chunk=chunk, cull=cull,
                                 alpha_test=alpha_test)
    got = rt.vao_interval_query(st, *(torch.as_tensor(r[k]) for k in keys),
                                chunk=chunk, cull=cull,
                                alpha_test=alpha_test)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).sum() > 10
        _assert_t(g.numpy(), w)


def test_queries_cull_work_not_hits(scenes):
    """On short rays the port's culled blocks evaluate fewer ray-triangle
    tests than the brute force; with every box widened to everything
    (PAD_REL huge) the hits are the same."""
    from unittest import mock
    _, st, r = scenes["soup"]
    r = _soup_rays(n=2048, seed=24)
    r["tmax"] = r["tmin"] + 0.3
    args = [torch.as_tensor(r[k]) for k in ("o", "d", "tmin", "tmax")]
    culled, brute = rt.query_tests(st, *args, chunk=16, ray_block=64)
    assert 0 < culled < brute
    t0, id0 = rt.closest_hit(st, *args, chunk=16, ray_block=64)
    with mock.patch.object(rt, "PAD_REL", 1e6):
        assert rt.query_tests(st, *args, chunk=16, ray_block=64)[0] > brute
        t1, id1 = rt.closest_hit(st, *args, chunk=16, ray_block=64)
    assert (id0.numpy() >= 0).sum() > 40
    np.testing.assert_array_equal(id0.numpy(), id1.numpy())
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())
