"""K12's host side on the CPU (ops/resolve_cuda.py): the float32 constants
the wrapper hands the kernel are, bit for bit, the scalars the plain
direction loop's PyTorch operations see, and on CPU tensors the wrapper is
that loop (passes/svao_shift.svao_resolve_plain), one direction at a time
or the whole ring at once. The kernel itself is held on a GPU only
(tests/test_torch_cuda.py).

This file imports neither jax nor rtsdm_tpu.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_cuda import _phase2_frame  # noqa: E402

from rtsdm_tpu_torch import _build  # noqa: E402
from rtsdm_tpu_torch.ops import ao as A  # noqa: E402
from rtsdm_tpu_torch.ops import ao_shift as S  # noqa: E402
from rtsdm_tpu_torch.ops import resolve_cuda as RV  # noqa: E402
from rtsdm_tpu_torch.passes import svao_shift as PH  # noqa: E402
from rtsdm_tpu_torch.utils.sampling import (AO_KERNEL_HBAO,  # noqa: E402
                                            AO_KERNEL_VAO)

ONE = torch.ones((), dtype=torch.float32)


def seen(x: float) -> float:
    """The float32 value PyTorch multiplies a float32 tensor by when the
    loop hands it the Python number x."""
    return float(ONE * x)


def bits(v) -> np.ndarray:
    return np.asarray(v, np.float32).view(np.int32)


def same(a, b) -> bool:
    """Equal bit for bit where b is a number, NaN where b is (the frame's
    depth at infinity)."""
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


@pytest.mark.parametrize("kernel", [AO_KERNEL_VAO, AO_KERNEL_HBAO])
@pytest.mark.parametrize("nd", [4, 8, 13])
def test_direction_constants_are_the_loops_float32_scalars(kernel, nd):
    """Per ring direction: sin and cos of the loop's alpha (its dxy), the
    radius fraction (its level lookup), the class screen directions of
    _class_consts and HBAO's pdf as torch.full_like makes it."""
    cfg = A.VAOConfig(num_directions=nd, kernel=kernel)
    levels, offs, radii, _ = PH._ring(cfg)
    tab = RV.direction_constants(radii)
    assert tab.shape == (nd, RV.DIR_CONSTS) and tab.dtype == np.float32
    for i in range(nd):
        alpha = (i / nd) * 2.0 * 3.141
        r = float(radii[i])
        ux, uy = PH._class_consts(alpha, torch.device("cpu"))
        pdf = torch.full_like(ONE, 0.9 * (1.0 - r) ** 1.5)
        want = [seen(math.sin(alpha)), seen(math.cos(alpha)), seen(r),
                float(pdf), *ux.reshape(16).tolist(),
                *uy.reshape(16).tolist()]
        np.testing.assert_array_equal(bits(tab[i]), bits(want))


@pytest.mark.parametrize("divisor", [1, 2, 4])
def test_config_constants_and_level_tables_are_the_loops(divisor):
    """1 + thickness and HBAO's radius^2 as the loop's PyTorch operations
    round them, the reciprocal PyTorch's CUDA division by float(divisor)
    multiplies by; the level bounds shift_level_index compares with and
    the level radii level_radius reads."""
    cfg = A.VAOConfig(radius=0.37, thickness=0.13, kernel=AO_KERNEL_HBAO)
    thick1, radius2, inv_div = RV.config_constants(cfg, divisor)
    assert bits(thick1) == bits(seen(1.0 + cfg.thickness))
    assert bits(radius2) == bits(float(torch.full(
        (), cfg.radius * cfg.radius, dtype=torch.float32)))
    assert bits(inv_div) == bits(float(ONE / torch.tensor(float(divisor))))
    levels, _, radii, _ = PH._ring(cfg)
    bounds, level_r, dirs = RV.ring_constants(
        tuple(float(v) for v in levels), tuple(float(r) for r in radii))
    np.testing.assert_array_equal(bits(dirs),
                                  bits(RV.direction_constants(radii)))
    np.testing.assert_array_equal(bits(bounds), bits(A.level_bounds(levels)))
    lvl = torch.arange(len(levels), dtype=torch.int32)
    np.testing.assert_array_equal(bits(level_r),
                                  bits(S.level_radius(levels, lvl)))
    # every bound is a level boundary shift_level_index finds
    r = torch.as_tensor(bounds)
    np.testing.assert_array_equal(
        A.shift_level_index(levels, r).numpy(), np.arange(len(bounds)))


def _phase2_args(kernel, divisor, k, seed):
    """svao_resolve's arguments but the SD values and d, built as
    svao_phase2_shift builds them, and the map."""
    rng = np.random.default_rng(seed)
    guard = 48 // divisor
    cam, cfg, depth, normal_v, stencil, sd_map, _ = _phase2_frame(
        "cpu", kernel, divisor, guard, k, rng)
    b = PH._prep_planar(cam, cfg, depth, normal_v)
    hp, wp = b["hp"], b["wp"]
    levels, offs, radii, pad = PH._ring(cfg)
    bq = PH._deint_b(b)
    h, w = depth.shape
    stencil_q = S.deinterleave(torch.nn.functional.pad(
        stencil, (0, wp - w, 0, hp - h)))
    fetched = PH.fetch_all_directions(
        [S.pad_planes(S.deinterleave(b["depth"]), pad)], pad,
        bq["radius_px"], levels, offs, radii)[0]
    return (cfg, bq, levels, offs, radii, fetched, stencil_q,
            cam.far_z - cam.near_z, cam.near_z, sd_map, guard)


@pytest.mark.parametrize("kernel", [AO_KERNEL_VAO, AO_KERNEL_HBAO])
def test_cpu_wrapper_is_the_plain_loop_a_direction_or_a_ring_at_a_time(
        kernel):
    """On CPU tensors the wrapper returns the plain loop's delta and
    launches nothing; the divisor-1 chain of one call a direction, each
    adding to the last's delta and leaving it as it was, equals one call
    over the ring on the stacked fetches bit for bit (the same sums in the
    same order)."""
    (cfg, bq, levels, offs, radii, fetched, stencil_q, depth_range, near_z,
     sd_map, guard) = _phase2_args(kernel, 1, 3, 5)
    rq = bq["radius_px"]
    sd = [PH.fetch_sd_strided(sd_map, guard, rq, levels, offs, radii, i, 1)
          for i in range(cfg.num_directions)]
    setting = (stencil_q, depth_range, near_z, 3, 1, True)
    _build.LAUNCHES.clear()
    delta = None
    for i, sd_i in enumerate(sd):
        before = None if delta is None else delta.clone()
        nxt = RV.svao_resolve(cfg, bq, levels, radii, fetched, sd_i,
                              *setting, delta, i)
        want = PH.svao_resolve_plain(cfg, bq, levels, radii, fetched, sd_i,
                                     *setting, delta, i)
        assert same(nxt, want)
        if before is not None:
            assert same(delta, before)
        delta = nxt
    ring = RV.svao_resolve(cfg, bq, levels, radii, fetched, torch.stack(sd),
                           *setting)
    assert sum(_build.LAUNCHES.values()) == 0
    assert same(delta, ring) and bool((ring != 0).any())


def test_resolve_args_mirror_the_kernels_struct():
    """ops/resolve_cuda.ResolveArgs declares csrc/svao_resolve.cu's
    ResolveArgs field for field (name, pointer, int, float or float array
    of the same length, in order), and the kernel's layout entry reports
    the offsets of those fields in that order. On a GPU the wrapper also
    holds the compiled struct's size and offsets (check_layout)."""
    import ctypes
    import re
    src = (Path(__file__).parents[1] / "rtsdm_tpu_torch" / "csrc"
           / "svao_resolve.cu").read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"struct ResolveArgs \{(.*?)\n\};", src, re.S)[1]
    declared = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        m = re.fullmatch(r"(const )?(\w+)(\*?) (.+);", decl)
        kind = "pointer" if m[3] else m[2]
        for name in m[4].split(","):
            arr = re.fullmatch(r"(\w+)\[(.+)\]", name.strip())
            if arr:
                declared.append((arr[1], kind,
                                 eval(arr[2], {}, dict(consts))))
            else:
                declared.append((name.strip(), kind, None))
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    mirrored = [(name, kinds[t._type_], t._length_) if hasattr(t, "_length_")
                else (name, kinds[t], None)
                for name, t in RV.ResolveArgs._fields_]
    assert mirrored == declared
    layout = re.search(r"sizeof\(ResolveArgs\),(.*?)\};", src, re.S)[1]
    assert re.findall(r"OFF\((\w+)\)", layout) == [n for n, _, _ in declared]
    assert RV.MAX_BOUNDS == consts["kMaxBounds"]
    assert RV.MAX_LAUNCH_DIRS == consts["kMaxLaunchDirs"]
    assert RV.DIR_CONSTS == consts["kDirConsts"]
