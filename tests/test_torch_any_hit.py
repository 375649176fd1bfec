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
    tri, lists, counts, rays = RT.any_hit_inputs(st, origins, d, tmin, tmax)
    hit, pairs = RT.any_hit_blocks(tri, lists, counts, rays)
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
