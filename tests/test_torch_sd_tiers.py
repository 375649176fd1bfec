"""The two tiers of the port's stochastic-depth ray trace on the CPU: K7's
plain version (resident tier, in-kernel chunk cull) against
rt_pallas.sd_trace_pallas and K5's plain version (streamed tier) against
rt_pallas.sd_trace_pallas_stream, both in interpret mode, in every
insertion mode and with a MaxCount; the two plain versions against each
other; and StochasticDepthMapRT's choice of tier. The kernels' own checks
against their plain versions run on a GPU (chip_smoke.py,
tests/test_torch_cuda.py).

Tolerances and why: the packed rows are bit-exact with the reference's. In
the trace XLA:CPU fuses the Möller-Trumbore dot products into multiply-adds
where PyTorch (and the kernels, built with --fmad=false) round each
product, so u and v can differ in the last bit and the 15-bit key, which
hashes them, flips for a share of the hits (tests/test_torch_sd_trace.py).
So, as the reference's own resident-vs-stream test does:
- default, kbuffer and MaxCount 2: which slots are empty, and the depths of
  every ray with fewer than k hits (every ray under MaxCount 2 < k), are
  bit-exact;
- coverage: which slot a hit lands in follows its key, so per slot nothing
  is bit-exact; what is, with alpha * k = 1.5 (every hit covers at least
  one slot): which rays have a hit and the nearest depth of each ray. Rays
  with any differing slot, measured: CornellBox 24 of 256, Arcade 17 of
  512; bound asserted: 1 in 8.
K7's plain version equals K5's bit for bit on the same rows in every mode:
both walk the chunks in order and skip only chunks without hits. On an SD
grid whose sides are not whole tiles, K7's 8x32 tiles give bit for bit
what its walk of 256 consecutive rays gives, and what K5 gives on the same
tiles; against sd_trace_pallas the contract above holds.
"""
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_pallas_interpret import _rays, interpret_mode  # noqa: E402
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.ops import rt_pallas as rp  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu_torch.ops import rt_cuda as RT  # noqa: E402
from rtsdm_tpu_torch.passes import stochastic_depth as SDT  # noqa: E402
from rtsdm_tpu_torch.rendergraph.render_pass import \
    RenderContext  # noqa: E402

K = 4
ALPHA = 0.375      # 1.5 / k, as SVAO gives its SD pass
MODES = [("default", 0), ("kbuffer", 0), ("coverage", 0), ("default", 2)]
MODE_IDS = ["default", "kbuffer", "coverage", "maxcount2"]


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module", params=[("CornellBox", 256),
                                        ("Arcade", 512)],
                ids=["CornellBox", "Arcade"])
def rays_case(request):
    """A scene (CornellBox: 1 chunk; Arcade: 1,170 triangles, 10 chunks)
    with seeded rays, in both packages, and both plain versions' output in
    every mode."""
    name, n = request.param
    sj = PJ.load_scene(name, aspect=16 / 9 if name == "Arcade" else 1.0)
    st = carry(sj)
    origins, dirs, tmin, tmax, cosw = _rays(sj, n=n, seed=7)
    tri_t, aabb_t = RT.prep_triangles_packed(st, True)
    tri_j, aabb_j = rp.prep_triangles_packed(sj, True)
    np.testing.assert_array_equal(RT.tri_rows(tri_t).numpy(),
                                  np.asarray(tri_j))
    cam = sj.camera
    port_args = (tri_t, aabb_t, st.camera.pos_w, t(dirs), t(tmin), t(tmax),
                 t(cosw), t(cam.near_z), t(cam.far_z))
    plain = {}
    for mode, mc in MODES:
        kw = dict(num_samples=K, mode=mode, max_count=mc, alpha=ALPHA)
        plain[mode, mc] = (RT.sd_trace_resident(*port_args, **kw).numpy(),
                           RT.sd_trace_stream(*port_args, **kw).numpy())
    return dict(sj=sj, rays=(origins, dirs, tmin, tmax, cosw), tri_j=tri_j,
                aabb_j=aabb_j, plain=plain)


def _reference(c, tier, mode, mc):
    sj = c["sj"]
    origins, dirs, tmin, tmax, cosw = c["rays"]
    kw = dict(num_samples=K, mode=mode, max_count=mc or None, alpha=ALPHA)
    with interpret_mode(rp):
        if tier == "resident":
            return np.asarray(rp.sd_trace_pallas(
                *rp.prep_triangles(sj, True), origins, dirs, tmin, tmax,
                cosw, sj.camera.near_z, sj.camera.far_z, **kw))
        return np.asarray(rp.sd_trace_pallas_stream(
            c["tri_j"], c["aabb_j"], origins, dirs, tmin, tmax, cosw,
            sj.camera.near_z, sj.camera.far_z, **kw))


def _assert_same_hits(got, ref, mode):
    inv = RT.INVALID
    assert (ref != inv).any()
    if mode == "coverage":
        np.testing.assert_array_equal((got != inv).any(1),
                                      (ref != inv).any(1))
        np.testing.assert_array_equal(got.min(1), ref.min(1))
        assert (got != ref).any(1).sum() <= got.shape[0] // 8
        return
    np.testing.assert_array_equal(got == inv, ref == inv)

    def depths(p):
        d = p // 32768 if mode == "kbuffer" else p % 65536
        return np.sort(np.where(p == inv, -1, d), axis=1)

    free = (ref != inv).sum(1) < K          # no selection pressure
    np.testing.assert_array_equal(depths(got)[free], depths(ref)[free])


@pytest.mark.parametrize("mode,mc", MODES, ids=MODE_IDS)
def test_resident_plain_matches_sd_trace_pallas(rays_case, mode, mc):
    got = rays_case["plain"][mode, mc][0]
    _assert_same_hits(got, _reference(rays_case, "resident", mode, mc), mode)
    if mc:
        assert ((got != RT.INVALID).sum(1) <= mc).all()


@pytest.mark.parametrize("mode,mc", MODES[2:], ids=MODE_IDS[2:])
def test_stream_plain_matches_sd_trace_pallas_stream(rays_case, mode, mc):
    """K5's coverage insertion and MaxCount (default and kbuffer are held
    by tests/test_torch_sd_trace.py)."""
    got = rays_case["plain"][mode, mc][1]
    _assert_same_hits(got, _reference(rays_case, "stream", mode, mc), mode)


@pytest.mark.parametrize("mode,mc", MODES, ids=MODE_IDS)
def test_resident_plain_equals_stream_plain(rays_case, mode, mc):
    resident, stream = rays_case["plain"][mode, mc]
    np.testing.assert_array_equal(resident, stream)


# an SD grid whose width is no multiple of 32 and height no multiple of 8
GRID_H, GRID_W = 21, 45


@pytest.fixture(scope="module")
def grid_case():
    """Pinhole rays through every texel of a GRID_H x GRID_W grid over
    Arcade (10 chunks), row-major, with seeded intervals (a few dead); the
    tiled K7 plain version's output in every mode."""
    sj = PJ.load_scene("Arcade", aspect=16 / 9)
    st = carry(sj)
    cam = sj.camera
    n = GRID_H * GRID_W
    py, px = np.meshgrid(np.arange(GRID_H), np.arange(GRID_W),
                         indexing="ij")
    signed = np.stack([px, py], -1).reshape(n, 2).astype(np.float32)
    origin, dirs = cam.compute_ray_pinhole(jnp.asarray(signed),
                                           (GRID_W, GRID_H),
                                           jitter=jnp.full((n, 2), 0.5))
    rng = np.random.default_rng(29)
    tmin = rng.uniform(0.0, 2.0, n).astype(np.float32)
    tmax = (tmin + rng.uniform(0.5, 8.0, n)).astype(np.float32)
    tmax[::97] = tmin[::97]                      # dead rays
    cosw = jnp.sum(dirs * (cam.camera_w / jnp.linalg.norm(cam.camera_w)),
                   -1)
    tri_t, aabb_t = RT.prep_triangles_packed(st, True)
    args = (tri_t, aabb_t, st.camera.pos_w, t(dirs), t(tmin), t(tmax),
            t(cosw), t(cam.near_z), t(cam.far_z))
    tiled = {}
    for mode, mc in MODES:
        kw = dict(num_samples=K, mode=mode, max_count=mc, alpha=ALPHA)
        tiled[mode, mc] = RT.sd_trace_resident(
            *args, grid=(GRID_H, GRID_W), **kw)
    return dict(sj=sj, args=args, tiled=tiled,
                rays=(jnp.broadcast_to(origin, (n, 3)), dirs, tmin, tmax,
                      cosw))


@pytest.mark.parametrize("mode,mc", MODES, ids=MODE_IDS)
def test_tiled_resident_plain_equals_row_major_walk(grid_case, mode, mc):
    """K7's plain version on the grid's 8x32 tiles equals its walk of 256
    consecutive row-major rays (the parent's blocking) and K5's plain
    version on the same tiles, bit for bit."""
    c = grid_case
    kw = dict(num_samples=K, mode=mode, max_count=mc, alpha=ALPHA)
    tiled = c["tiled"][mode, mc]
    assert tiled.shape == (GRID_H * GRID_W, K)
    assert bool((tiled != RT.INVALID).any())
    row_major = RT.sd_trace_resident(*c["args"], **kw)
    np.testing.assert_array_equal(tiled.numpy(), row_major.numpy())
    tri, aabb, origin, dirs, tmin, tmax, cosw, near, far = c["args"]

    def tf(a, fill=0.0):                          # 8x32-tile order
        return RT.tile_flatten(RT.pad_tile(
            a.reshape((GRID_H, GRID_W) + a.shape[1:]), fill)[0])

    stream = RT.sd_trace_stream(tri, aabb, origin, tf(dirs), tf(tmin),
                                tf(tmax, -1.0), tf(cosw), near, far, **kw)
    ph, pw = GRID_H + (-GRID_H) % 8, GRID_W + (-GRID_W) % 32
    stream = RT.tile_unflatten(stream, ph, pw)[:GRID_H, :GRID_W]
    np.testing.assert_array_equal(tiled.numpy(),
                                  stream.reshape(-1, K).numpy())


@pytest.mark.parametrize("mode,mc", MODES[2:], ids=MODE_IDS[2:])
def test_tiled_resident_plain_matches_sd_trace_pallas(grid_case, mode, mc):
    """The tiled walk against rt_pallas.sd_trace_pallas in interpret mode
    on the grid's rays, under the contract of the module docstring."""
    c = grid_case
    got = c["tiled"][mode, mc].numpy()
    _assert_same_hits(got, _reference(c, "resident", mode, mc), mode)
    if mc:
        assert ((got != RT.INVALID).sum(1) <= mc).all()


def test_coverage_decodes_per_slot_depths():
    packed = torch.tensor([[0, 65535, RT.INVALID, 32768]], dtype=torch.int32)
    d = RT.decode_packed(packed, torch.tensor(0.5), torch.tensor(10.0),
                         mode="coverage")
    np.testing.assert_array_equal(
        d.numpy(), np.float32([[0.0, 1.0, 1.0, 32768 / 65535]]))


def _sd_inputs(st, size=16):
    """StochasticDepthMapRT inputs for a size x size SD grid: a depth field
    at 1, every texel requested over [0, 8]."""
    z = torch.ones((size, size))
    return (RenderContext(width=size, height=size, scene=st),
            {"linearZ": z, "rayMin": torch.zeros_like(z),
             "rayMax": torch.full_like(z, 8.0)})


@pytest.mark.parametrize("stream,impl,max_count", [
    ("auto", "default", 0), ("auto", "coverage", 0), ("auto", "kbuffer", 8),
    (True, "default", 0), (False, "kbuffer", 0)])
def test_pass_takes_the_reference_tier(stream, impl, max_count):
    """pallasStream 'auto' stays resident (K7) up to 65,536 triangles and
    streams (K5) above; True and False force a tier. Every mode renders."""
    st = carry(PJ.cornell_box())
    calls = []
    real_r, real_s = RT.sd_trace_resident_blocks, RT.sd_trace_blocks

    def rec(tier, real):
        def f(*a, **kw):
            calls.append(tier)
            return real(*a, **kw)
        return f

    p = SDT.StochasticDepthMapRT(dict(pallasStream=stream,
                                      Implementation=impl,
                                      MaxCount=max_count, Alpha=ALPHA))
    with mock.patch.object(RT, "sd_trace_resident_blocks",
                           rec("resident", real_r)), \
            mock.patch.object(RT, "sd_trace_blocks", rec("stream", real_s)):
        out, _ = p.execute(*_sd_inputs(st))
        if stream == "auto":
            with mock.patch.object(SDT, "RESIDENT_MAX_TRIANGLES",
                                   st.num_triangles - 1):
                p.execute(*_sd_inputs(st))
    want = {"auto": ["resident", "stream"], True: ["stream"],
            False: ["resident"]}[stream]
    assert calls == want
    assert SDT.RESIDENT_MAX_TRIANGLES == 65536
    d = out["stochasticDepth"]
    assert d.shape == (16, 16, 4) and bool(((d >= 0) & (d <= 1)).all())
    assert bool((d < 1).any())


def test_svao_gives_its_sd_pass_alpha_and_use_pallas():
    """SVAO hands the nested StochasticDepthMapRT Alpha = 1.5 / stochSamples
    and its usePallas, as the reference package does (svao.py:135-152)."""
    from rtsdm_tpu_torch.passes.svao import SVAO
    st = carry(PJ.cornell_box())
    svao = SVAO(dict(stochSamples=3, usePallas=False, stochMaxCount=8))
    svao.set_scene(st)
    sd = svao._nested_graph(st).passes["StochasticDepthMap"]
    assert sd.pass_type == "StochasticDepthMapRT"
    assert sd.cfg["Alpha"] == 1.5 / 3
    assert sd.cfg["usePallas"] is False
    assert sd.cfg["MaxCount"] == 8
    for key, bad in (("traceOutOfScreen", True),
                     ("maxRayBudgetFraction", 0.25)):
        with pytest.raises(NotImplementedError):
            SVAO({key: bad})
