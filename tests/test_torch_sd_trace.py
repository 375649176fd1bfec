"""Parity of the port's stochastic-depth ray trace (K5) and its host-side
packing and chunk lists with rtsdm_tpu on the CPU, and the plain replay of
the lists K5 and K7 build inside the kernel against build_chunk_lists; the
kernel's own check against its plain version runs on a GPU only
(tests/test_torch_cuda.py).

Reference: rt_pallas.sd_trace_pallas_stream in interpret mode on the same
scene, rays and packed rows.

Tolerances and why: triangle packing, chunk AABBs, screen cull rows and
chunk lists are bit-exact. Inside the trace XLA:CPU fuses the
Möller-Trumbore dot products into multiply-adds while PyTorch (and the
CUDA kernel, built with --fmad=false) rounds each product, so u and v can
differ in the last bit; the 15-bit reservoir key hashes (u * 8388593)
truncated to an integer, and such a bit flips the key for a share of the
hits (measured: 31 of 164 hits on CornellBox, 8 of 50 on Arcade). The
contract tested is therefore the one the reference's own resident-vs-
stream test uses: identical hit sets — which slots are empty, and the
16-bit depths of every ray that has fewer than k hits — bit-exact; the key
function itself is bit-exact on identical (u, v).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
from test_pallas_interpret import _rays, interpret_mode  # noqa: E402
from test_torch_scene import carry  # noqa: E402

from rtsdm_tpu.ops import rt_pallas as rp  # noqa: E402
from rtsdm_tpu.scene import procedural as PJ  # noqa: E402
from rtsdm_tpu_torch.ops import rt_cuda as RT  # noqa: E402

INT_MIN = -2**31


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module", params=[("CornellBox", 256),
                                        ("Arcade", 512)])
def trace_case(request):
    name, n = request.param
    sj = PJ.load_scene(name, aspect=16 / 9 if name == "Arcade" else 1.0)
    st = carry(sj)
    origins, dirs, tmin, tmax, cosw = _rays(sj, n=n, seed=7)
    cam = sj.camera
    res = 256
    # the rays' signed texel coordinates, for the pinhole screen cull
    au = jnp.sum(dirs * cam.camera_u, -1) / jnp.sum(cam.camera_u ** 2)
    av = jnp.sum(dirs * cam.camera_v, -1) / jnp.sum(cam.camera_v ** 2)
    aw = jnp.sum(dirs * cam.camera_w, -1) / jnp.sum(cam.camera_w ** 2)
    rx = (au / aw + 1.0) * 0.5 * res - 0.5
    ry = (1.0 - av / aw) * 0.5 * res - 0.5
    tri_j, aabb_j = rp.prep_triangles_packed(sj, True)
    scr_j = rp.chunk_screen_rows(aabb_j, origins[0], cam.camera_u,
                                 cam.camera_v, cam.camera_w, res, res)
    aabb12 = jnp.concatenate([aabb_j[:6], scr_j], 0)
    return dict(sj=sj, st=st, rays=(origins, dirs, tmin, tmax, cosw),
                rx=rx, ry=ry, res=res, tri_j=tri_j, aabb_j=aabb_j,
                scr_j=scr_j, aabb12=aabb12)


def test_packing_and_lists_match_reference(trace_case):
    c = trace_case
    st, cam = c["st"], c["sj"].camera
    origins, dirs, tmin, tmax, _ = c["rays"]
    tri_t, aabb_t = RT.prep_triangles_packed(st, True)
    # the kernel's triangle-major layout holds the reference's rows
    np.testing.assert_array_equal(RT.tri_rows(tri_t).numpy(),
                                  np.asarray(c["tri_j"]))
    np.testing.assert_array_equal(RT.tri_major(t(c["tri_j"])).numpy(),
                                  tri_t.numpy())
    np.testing.assert_array_equal(aabb_t.numpy(), np.asarray(c["aabb_j"]))
    scr_t = RT.chunk_screen_rows(aabb_t, st.camera.pos_w, st.camera.camera_u,
                                 st.camera.camera_v, st.camera.camera_w,
                                 c["res"], c["res"])
    np.testing.assert_array_equal(scr_t.numpy(), np.asarray(c["scr_j"]))
    lists_j, counts_j = rp.build_chunk_lists(c["aabb12"], origins, dirs,
                                             tmin, tmax, rx=c["rx"],
                                             ry=c["ry"])
    lists_t, counts_t = RT.build_chunk_lists(
        t(c["aabb12"]), t(cam.pos_w), t(dirs), t(tmin), t(tmax), t(c["rx"]),
        t(c["ry"]))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(lists_t.numpy(),
                                  np.asarray(lists_j)[:, :lists_t.shape[1]])


@pytest.mark.parametrize("mode", ["default", "kbuffer"])
def test_trace_matches_pallas_interpret(trace_case, mode):
    c = trace_case
    cam = c["sj"].camera
    origins, dirs, tmin, tmax, cosw = c["rays"]
    k = 4
    with interpret_mode(rp):
        ref = np.asarray(rp.sd_trace_pallas_stream(
            c["tri_j"], c["aabb12"], origins, dirs, tmin, tmax, cosw,
            cam.near_z, cam.far_z, num_samples=k, mode=mode, rx=c["rx"],
            ry=c["ry"]))
    got = RT.sd_trace_stream(
        RT.tri_major(t(c["tri_j"])), t(c["aabb12"]), t(cam.pos_w), t(dirs),
        t(tmin), t(tmax), t(cosw), t(cam.near_z), t(cam.far_z),
        num_samples=k, mode=mode, rx=t(c["rx"]), ry=t(c["ry"])).numpy()
    assert (ref != RT.INVALID).any()
    np.testing.assert_array_equal(got == RT.INVALID, ref == RT.INVALID)
    # slots ascend, valid values distinct
    assert (np.diff(got.astype(np.int64), axis=1) >= 0).all()
    assert ((np.diff(got.astype(np.int64), axis=1) > 0)
            | (got[:, 1:] == RT.INVALID)).all()

    def depths(p):
        d = p // 32768 if mode == "kbuffer" else p % 65536
        return np.sort(np.where(p == RT.INVALID, -1, d), axis=1)

    free = (ref != RT.INVALID).sum(1) < k   # no selection pressure
    np.testing.assert_array_equal(depths(got)[free], depths(ref)[free])
    np.testing.assert_array_equal(
        RT.decode_packed(t(ref), t(cam.near_z), t(cam.far_z),
                         mode=mode).numpy(),
        np.asarray(rp.decode_packed(jnp.asarray(ref), cam.near_z, cam.far_z,
                                    mode=mode)))


def _assert_lists_equal(replay, built, n_chunks, cap=RT.LIST_CAP):
    """The kernel's lists (block_lists_replay) against build_chunk_lists:
    the same unclamped counts, and the same ascending ids for every block
    that does not overflow the width."""
    (lists_r, counts_r), (lists_b, counts_b) = replay, built
    width = RT.list_width(n_chunks, cap)
    assert lists_r.shape == lists_b.shape == (counts_b.shape[0], width)
    np.testing.assert_array_equal(counts_r.numpy(), counts_b.numpy())
    fits = (counts_b <= width).numpy()
    np.testing.assert_array_equal(lists_r.numpy()[fits],
                                  lists_b.numpy()[fits])
    return fits


@pytest.mark.parametrize("screen", [True, False], ids=["K5", "world"])
def test_kernel_lists_replay_equals_build_chunk_lists(trace_case, screen):
    """K5's in-kernel lists (world and screen tests) and K7's (world test,
    no width) on the scene's rays, in 8x32-tile order."""
    c = trace_case
    cam = c["sj"].camera
    _, dirs, tmin, tmax, cosw = (t(a) for a in c["rays"])
    rays = RT._ray_rows(dirs, tmin, tmax, cosw, t(cam.near_z),
                        t(cam.far_z))
    pad = rays.shape[1] - dirs.shape[0]
    rx, ry = (torch.nn.functional.pad(t(c[k]), (0, pad)) if screen else None
              for k in ("rx", "ry"))
    aabb, origin = t(c["aabb12"]), t(c["sj"].camera.pos_w)
    n = aabb.shape[1]
    for cap in ((RT.LIST_CAP,) if screen else (RT.LIST_CAP, n)):
        _assert_lists_equal(
            RT.block_lists_replay(aabb, origin, rays, rx, ry, cap),
            RT.build_chunk_lists(aabb, origin, rays[0:3].T, rays[3], rays[4],
                                 rx, ry, cap=cap), n, cap)


def test_kernel_lists_replay_width_and_overflow():
    """A synthetic case above 2 * LIST_CAP chunks (width LIST_CAP): 600
    chunk boxes fill the half space x < -1, 700 small ones are spread
    through the scene. The tile of rays into x < 0 overlaps more chunks
    than the width and walks every chunk; the tile into x > 0 lists its
    few, in ascending order across the LIST_WINDOW windows."""
    rng = np.random.default_rng(3)
    n_big, n_small = 600, 700
    n = n_big + n_small
    assert n > 2 * RT.LIST_CAP
    lo = np.concatenate([np.tile([-10.0, -10.0, -10.0], (n_big, 1)),
                         rng.uniform(-10.0, 9.5, (n_small, 3))])
    hi = np.concatenate([np.tile([-1.0, 10.0, 10.0], (n_big, 1)),
                         lo[n_big:] + 0.5])
    order = rng.permutation(n)          # big boxes in every window
    lo, hi = lo[order], hi[order]
    big = 3e38
    scr_lo = np.where(order[:, None] < n_big, [-big, -big, 0.0],
                      rng.uniform(-20.0, 40.0, (n, 3)) * [1.0, 1.0, 0.0])
    scr_hi = np.where(order[:, None] < n_big, [big, big, big],
                      scr_lo + [30.0, 30.0, 20.0])
    aabb = torch.as_tensor(np.concatenate([lo, hi, scr_lo, scr_hi], 1).T
                           .astype(np.float32)).contiguous()
    d = rng.normal(size=(2 * RT.RB, 3))
    d[:, 0] = np.where(np.arange(2 * RT.RB) < RT.RB, -1.0, 1.0) \
        * (np.abs(d[:, 0]) + 0.5)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rng.uniform(0.0, 2.0, 2 * RT.RB)
    tmax = tmin + rng.uniform(0.5, 8.0, 2 * RT.RB)
    tmax[5] = tmin[5] - 1.0             # a dead ray adds nothing
    rays = RT._ray_rows(t(d.astype(np.float32)),
                        t(tmin.astype(np.float32)),
                        t(tmax.astype(np.float32)),
                        torch.ones(2 * RT.RB), torch.tensor(0.1),
                        torch.tensor(100.0))
    rx, ry = (t(rng.uniform(0.0, 32.0, 2 * RT.RB).astype(np.float32))
              for _ in range(2))
    origin = torch.zeros(3)
    replay = RT.block_lists_replay(aabb, origin, rays, rx, ry)
    built = RT.build_chunk_lists(aabb, origin, rays[0:3].T, rays[3],
                                 rays[4], rx, ry)
    fits = _assert_lists_equal(replay, built, n)
    counts = built[1].numpy()
    assert counts[0] > RT.LIST_CAP and not fits[0]     # overflows: walks all
    assert 0 < counts[1] <= RT.LIST_CAP and fits[1]
    listed = replay[0][1, :counts[1]].numpy()
    assert (np.diff(listed) > 0).all()
    assert listed.max() >= RT.LIST_WINDOW               # past one window


@pytest.mark.parametrize("wrapper", ["sd_trace_blocks",
                                     "sd_trace_resident_blocks"])
def test_trace_wrappers_refuse_misaligned_triangles(wrapper):
    """K5 and K7 copy tri_packed as float4s: a contiguous view that does
    not start on a 16-byte boundary is refused before any launch, on every
    device; the same shapes, aligned, pass."""
    buf = torch.zeros(RT.TC * RT.PACK_W + 1)
    tri = buf[1:].view(1, RT.TC, RT.PACK_W)
    assert tri.is_contiguous() and tri.data_ptr() % 16
    aabb, origin, rays = torch.zeros(6, 1), torch.zeros(3), \
        torch.zeros(7, RT.RB)
    with pytest.raises(ValueError, match="16-byte"):
        getattr(RT, wrapper)(tri, aabb, origin, rays, 4)
    out = getattr(RT, wrapper)(tri.clone(), aabb, origin, rays, 4)
    assert (out == RT.INVALID).all()


def _reference_keys(u, v):
    """rt_pallas._hash_tail's key expression, verbatim, in jnp."""
    hb = (u * 8388593.0).astype(jnp.int32) ^ (
        (v * 4194301.0).astype(jnp.int32) << 7)
    hb = (hb ^ (hb >> 8)) * jnp.int32(0x9E3779B1 - (1 << 32))
    hb = hb ^ (hb >> 13)
    return np.asarray(jnp.abs(hb) % 32767)


def test_key_hash_semantics_match_reference():
    """Wrapping int32 multiply, arithmetic >>, and |hb| floor-mod 32767
    where |INT_MIN| stays INT_MIN (key 32765)."""
    rng = np.random.default_rng(5)
    u = rng.uniform(0, 1, 20000).astype(np.float32)
    v = rng.uniform(0, 1, 20000).astype(np.float32)
    hb = np.array([INT_MIN, INT_MIN + 1, -1, 0, 1, 32767, -32767, 2**31 - 1,
                   -65534], np.int32)
    key_uv, key_hb = RT.sd_keys(t(u), t(v), t(np.resize(hb, u.shape)))
    np.testing.assert_array_equal(key_uv.numpy(), _reference_keys(u, v))
    want_hb = np.asarray(jnp.abs(jnp.asarray(hb)) % 32767)
    assert want_hb[0] == 32765
    np.testing.assert_array_equal(key_hb.numpy()[:len(hb)], want_hb)


def test_reservoir_is_bottom_k_distinct():
    """k slots hold the k smallest distinct packed hits: the k=2 reservoir
    is the head of the k=8 one, and duplicate triangles add no slot."""
    sj = PJ.arcade()
    st = carry(sj)
    pos = torch.cat([st.positions, st.positions])    # every hit twice
    st2 = type(st)(**{**st.__dict__, "positions": pos,
                      **{f: torch.cat([getattr(st, f)] * 2)
                         for f in ("normals", "texcoords", "material_id",
                                   "tri_alpha_mask")}})
    origins, dirs, tmin, tmax, cosw = _rays(sj, n=512, seed=19)
    tmax = tmax * 0 + 200.0                          # long rays: many hits
    tri, aabb = RT.prep_triangles_packed(st2, True)
    cam = st.camera
    args = (tri, aabb, cam.pos_w, t(dirs), t(tmin), t(tmax), t(cosw),
            cam.near_z, cam.far_z)
    k8 = RT.sd_trace_stream(*args, num_samples=8).numpy()
    k2 = RT.sd_trace_stream(*args, num_samples=2).numpy()
    assert ((k8 != RT.INVALID).sum(1) > 2).any()
    np.testing.assert_array_equal(k2, k8[:, :2])
    valid = k8 != RT.INVALID
    assert (np.diff(k8.astype(np.int64), axis=1)[valid[:, 1:]] > 0).all()
