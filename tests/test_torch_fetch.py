"""Parity of the port's shifted fetches — K3 (fetch_all_directions), K4
(fetch_sd_packed), the 16-bit SD unpack and the per-direction plain forms —
with rtsdm_tpu on the CPU; the kernels' own checks run on a GPU only
(tests/test_torch_cuda.py).

Every output here is a copy of an input selected by integer logic (the
radius level is one float32 product compared with float32 bounds), so all
comparisons are bit-exact.
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
from test_pallas_interpret import interpret_mode  # noqa: E402

import rtsdm_tpu.ops.ao as AJ  # noqa: E402
import rtsdm_tpu.ops.ao_shift as SJ  # noqa: E402
import rtsdm_tpu.ops.fetch_pallas as FJ  # noqa: E402
from rtsdm_tpu_torch.ops import ao as A  # noqa: E402
from rtsdm_tpu_torch.ops import ao_shift as S  # noqa: E402
from rtsdm_tpu_torch.ops import fetch_cuda as F  # noqa: E402


class _Cfg:
    """Two ring directions: the Pallas kernels' interpret mode costs
    seconds per direction, and the mapping is the same for every one."""
    num_directions = 2

    def radii(self):
        return np.asarray([0.75, 0.25], np.float32)


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(3)
    h, w = 64, 128
    levels, offs, radii = SJ.offset_tables(_Cfg(), 20.0)
    pad = int(-(-float(levels[-1]) // 4)) + 1
    depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    radius_px = rng.uniform(0.5, 30.0, (h, w)).astype(np.float32)
    return dict(h=h, w=w, levels=levels, offs=offs, radii=radii, pad=pad,
                depth=depth, depth2=depth + 0.5, radius_px=radius_px,
                rng=rng)


def test_tables_and_levels_match_reference(planes):
    for r in (8.0, 64.0, 512.0):
        np.testing.assert_array_equal(A.shift_radius_levels(r),
                                      AJ.shift_radius_levels(r))
    lv_t, offs_t, radii_t = S.offset_tables(_Cfg(), 20.0)
    assert offs_t == planes["offs"]
    np.testing.assert_array_equal(radii_t, planes["radii"])
    levels = AJ.shift_radius_levels(512.0)
    # radii just around every bound, plus random ones
    b = A.level_bounds(levels)
    r = np.concatenate([b, np.nextafter(b, 0), np.nextafter(b, 1e9),
                        planes["rng"].uniform(0, 80, 500)]).astype(np.float32)
    np.testing.assert_array_equal(
        A.shift_level_index(levels, torch.as_tensor(r)).numpy(),
        np.asarray(AJ.shift_level_index(levels, jnp.asarray(r))))
    lvl = np.arange(len(levels), dtype=np.int32)
    np.testing.assert_allclose(
        S.level_radius(levels, torch.as_tensor(lvl)).numpy(),
        np.asarray(SJ.level_radius(levels, jnp.asarray(lvl))), rtol=1e-6)


def test_deinterleave_and_pad_match_reference(planes):
    d = planes["depth"]
    dq = S.deinterleave(torch.as_tensor(d))
    np.testing.assert_array_equal(dq.numpy(),
                                  np.asarray(SJ.deinterleave(jnp.asarray(d))))
    np.testing.assert_array_equal(S.interleave(dq, 64, 128).numpy(), d)
    np.testing.assert_array_equal(
        S.pad_planes(dq, 5).numpy(),
        np.asarray(SJ.pad_planes(SJ.deinterleave(jnp.asarray(d)), 5)))


def test_fetch_all_directions_matches_pallas_interpret(planes):
    p = planes
    sets_j = [SJ.pad_planes(SJ.deinterleave(jnp.asarray(x)), p["pad"])
              for x in (p["depth"], p["depth2"])]
    rq_j = SJ.deinterleave(jnp.asarray(p["radius_px"]))
    with interpret_mode(FJ):
        want = FJ.fetch_all_directions(sets_j, p["pad"], rq_j, p["levels"],
                                       p["offs"], p["radii"])
    got = F.fetch_all_directions(
        [torch.as_tensor(np.array(s)) for s in sets_j], p["pad"],
        torch.as_tensor(np.array(rq_j)), p["levels"], p["offs"],
        p["radii"])
    assert len(got) == 2
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_fetch_sd_packed_matches_pallas_interpret(planes):
    """k = 3: plane 0 packs layers 0|1, plane 1 layer 2 and a zero half."""
    p, k = planes, 3
    qh, qw = p["h"] // 4, p["w"] // 4
    guard = 24
    sd = p["rng"].uniform(0.0, 1.0, (qh + 2 * guard, qw + 2 * guard, k)) \
        .astype(np.float32)
    rq = SJ.deinterleave(jnp.asarray(p["radius_px"]))
    with interpret_mode(FJ):
        want = FJ.fetch_sd_packed(jnp.asarray(sd), guard, rq, p["levels"],
                                  p["offs"], p["radii"], p["pad"])
    got = F.fetch_sd_packed(torch.as_tensor(sd), guard,
                            torch.as_tensor(np.array(rq)), p["levels"],
                            p["offs"], p["radii"], p["pad"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the unpacked layers match the reference unpack, layer by layer
    for kk in range(k):
        np.testing.assert_array_equal(
            F.unpack_sd16(got, kk).numpy(),
            np.asarray(FJ.unpack_sd16(want, kk)))


def test_fetch_sd_packed_declines_tiny_maps(planes):
    """An SD map narrower than its declared guard band clamps origins out
    of the pad halo -> None in both packages (the caller then takes
    fetch_sd_direction)."""
    p = planes
    sd = np.zeros((p["h"] // 4 + 2, p["w"] // 4 + 2, 2), np.float32)
    rq = SJ.deinterleave(jnp.asarray(p["radius_px"]))
    assert FJ.fetch_sd_packed(jnp.asarray(sd), 24, rq, p["levels"],
                              p["offs"], p["radii"], p["pad"]) is None
    assert F.fetch_sd_packed(torch.as_tensor(sd), 24,
                             torch.as_tensor(np.array(rq)), p["levels"],
                             p["offs"], p["radii"], p["pad"]) is None


def test_unpack_sd16_logical_shift_and_true_division():
    """The high half is a logical shift (a depth >= 32768 in an odd slot
    must not decode negative) and the divide is a true float32 division:
    every 16-bit code decodes to float32(n) / float32(65535) exactly."""
    n = np.arange(65536, dtype=np.int64)
    packed = ((n[::-1] << 16) | n)
    packed = np.where(packed >= 2**31, packed - 2**32, packed).astype(np.int32)
    pk = torch.as_tensor(packed.reshape(1, 256, 256))
    want = (n.astype(np.float32) / np.float32(65535.0)).reshape(256, 256)
    np.testing.assert_array_equal(F.unpack_sd16(pk, 0).numpy(), want)
    np.testing.assert_array_equal(F.unpack_sd16(pk, 1).numpy(),
                                  want.reshape(-1)[::-1].reshape(256, 256))
    np.testing.assert_array_equal(
        F.unpack_sd16(pk, 1).numpy(),
        np.asarray(FJ.unpack_sd16(jnp.asarray(packed.reshape(1, 256, 256)),
                                  1)))


@pytest.mark.parametrize("divisor", [4, 2])
def test_fetch_sd_direction_matches_reference(planes, divisor):
    p = planes
    qh, qw = p["h"] // 4, p["w"] // 4
    guard = 10
    s = 4 // divisor
    sd = p["rng"].uniform(0, 1, (qh * s + 2 * guard, qw * s + 2 * guard, 2)) \
        .astype(np.float32)
    lvl = SJ.deinterleave(AJ.shift_level_index(
        p["levels"], jnp.asarray(p["radius_px"]) * p["radii"][1]))
    for d in (0, 1):
        want = SJ.fetch_sd_direction(jnp.asarray(sd), lvl, p["offs"][d],
                                     guard, qh, qw, divisor)
        got = S.fetch_sd_direction(torch.as_tensor(sd),
                                   torch.as_tensor(np.array(lvl)),
                                   p["offs"][d], guard, qh, qw, divisor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cached_ring_tables_equal_uncached():
    """SVAO's ring tables are built once per configuration and kept
    immutable; K3's and K4's wrappers find their device tables by those
    objects (no call walks or hashes the offsets), and the cached tables
    equal tables built anew from the uncached offset_tables."""
    import dataclasses

    from rtsdm_tpu_torch.passes import svao_shift as PH
    cfg = A.VAOConfig(num_directions=8, ss_max_radius=512.0)
    ring = PH._ring(cfg)
    assert PH._ring(dataclasses.replace(cfg, resolution=(64, 48))) is ring
    levels, offs, radii, pad = ring
    assert not levels.flags.writeable
    lv, of, ra = S.offset_tables(cfg, 512.0)
    np.testing.assert_array_equal(levels, lv)
    assert offs == tuple(tuple(tuple(c) for c in d) for d in of)
    assert radii == tuple(float(r) for r in ra)
    assert pad == int(-(-float(lv[-1]) // 4)) + 1
    dev = torch.device("cpu")
    for kind, extra in (("dir", (pad,)),
                        ("sd", (128, pad, 528, 736, 68, 120))):
        cached = F._tables(kind, levels, offs, radii, extra, dev)
        assert F._tables(kind, levels, offs, radii, extra, dev) is cached
        fresh = F._tables(kind, lv, of, ra, extra, dev)
        assert fresh is not cached
        for c, f in zip(cached[:3], fresh[:3]):
            assert torch.equal(c, f)
        assert cached[3] == fresh[3]
