"""Parity of the port's stochastic-depth ray trace (K5) and its host-side
packing and chunk lists with rtsdm_tpu on the CPU; the kernel's own check
against its plain version runs on a GPU only (tests/test_torch_cuda.py).

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
    np.testing.assert_array_equal(tri_t.numpy(), np.asarray(c["tri_j"]))
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
        t(c["tri_j"]), t(c["aabb12"]), t(cam.pos_w), t(dirs), t(tmin),
        t(tmax), t(cosw), t(cam.near_z), t(cam.far_z), num_samples=k,
        mode=mode, rx=t(c["rx"]), ry=t(c["ry"])).numpy()
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
