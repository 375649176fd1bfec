#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (rtsdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. refuse to run without a CUDA device, or outside a checkout of the repo;
2. print the card's name and power limit (nvidia-smi);
3. build the CUDA kernels (csrc/*.cu, one nvcc per source, sm_90a) and the
   scene helper;
4. drive the SVAO path once, as bench.py does, at SunTemple@full 1920x1080:
   G-buffer -> linearize -> packed view normals -> SVAO.execute (phase 1,
   nested SD ray-trace graph, phase 2). Every kernel's launch count is
   zeroed just before and read just after; each of the five must have
   launched, and no plain PyTorch version may run. The inputs each kernel
   got are kept for phase 5;
5. hold each kernel against its plain PyTorch version on those inputs, on
   the card, with the tolerance stated, and time both (CUDA events);
6. time a steady-state frame stage by stage (CUDA events) and through the
   public entry points (host clock), and profile one frame (torch.profiler:
   device time by kernel, and the device's idle share of the frame);
7. render CornellBox 64x64 on the card and on the CPU (the plain versions,
   which tests/test_torch_*.py hold against the JAX package) and compare
   the AO with the bound those tests use;
8. the graph path: scripts/SVAO_small.py (the README's four outputs) through
   rtsdm_tpu_torch.mogwai at SunTemple@full 1920x1080 with the script's own
   properties, 3 frames on a paused clock. Counts are zeroed before and read
   after every frame: per frame K10 (warp_resample) launches at least 6
   times, K8 (any_hit) once per light, K1 and K2 twice (ForwardLighting
   re-rasters), K3-K5 as on the SVAO path; no plain version runs. The four
   marked outputs are cropped to 1080x1920 and finite, and AO lies in [0, 1];
9. hold K8 and K10 against their plain versions on the inputs of the graph's
   last frame (K8 on a spread subset of whole 8x32 tiles), and K10 also on a
   synthetic motion field at the TAA shape; time the kernels, their plain
   versions and K10's library yardstick (grid_sample);
10. time the graph frame: host-clock median over 7 frames after a warm-up,
   per-pass CUDA events, and one profiled frame (device busy, idle share);
11. BASELINE config 2 (bench_configs.py:20-23): scripts/SVAO_small.py with
   SVAO's stochasticDepthImpl set to 'Raster' after the graph was built,
   Arcade@full 1280x720, 3 frames. Per frame K9 (raster_stochastic)
   launches once and K5 never; K1-K4 and K8 as the graph gives them. Every
   call of the last frame of K1-K4, K8 and K10 is held bit-exact against its
   plain version at the config's shapes (K4 with no SD guard band; K8 on a
   spread subset of tiles), and so is K9, at the path's alpha and at 1.0,
   and timed; then the frame is timed as in 10;
12. BASELINE config 1: scripts/HBAO.py on CornellBox 256x256, 3 frames. Per
   frame K6 (fetch_taps_same_class) launches once and K1 once with its
   depth floor (DepthPeeling) besides its two plain launches; the last
   frame's calls held as in 11; then one frame with HBAO's depthMode set to
   DualDepth (K6 on two plane sets); timed as in 10;
13. config 1's graph again on SunTemple@full 1920x1080, where K6 and the
   floored K1 do real work: the last frame's calls held as in 11, K6 held
   bit-exact on every call kept (also the CornellBox and DualDepth calls),
   K6 and the floored K1 timed; the frame timed as in 10;
14. both configs' graphs and scripts/SVAO.py at their golden settings on
   the card (tests/image_tests/renderpasses/test_HBAO.py,
   test_SVAO_rasterSD.py, test_SVAO_full.py; SVAO.py traces with K7), held
   against the committed goldens by the golden runner's MSE bound;
15. scripts/SVAO.py (the reference's shipped SVAO graph) at Arcade@full
   1280x720 through Renderer.renderFrame, 3 frames: per frame K7
   (sd_trace_resident: 38,610 triangles, at most 65,536) launches once and
   K5 never; the last frame's calls of K1-K4, K7, K8 and K10 held
   bit-exact against their plain versions; one frame with SVAO's
   stochMaxCount 8 (K7 with the cap, held); StochasticDepthMapRT at that
   frame's SD inputs in the default, kbuffer, coverage (alpha 0.375) and
   MaxCount 8 settings on both tiers, each call held and K7 equal to K5
   bit for bit; K7 and K5 timed on the same rays; the frame timed as in
   10. (Phase 5 also runs the SVAO path once with stochMaxCount 8: K5 with
   the cap, held and timed.)

The last three lines are JSON: the frames' times, one entry per kernel
({"kernels": [...]}, with its bound and library yardstick), and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT = 1920, 1080
GRAPH_SCRIPT = ROOT / "scripts" / "SVAO_small.py"
GRAPH_SCENE = "SunTemple@full"
GRAPH_FRAMES = 3
# the H100's published peaks (NVIDIA's data sheet, SXM part, at 700 W): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# fp32 operations over the fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SVAO_PROPS = {"secondaryDepthMode": "StochasticDepth",
              "stochasticDepthImpl": "Ray", "radius": 0.2,
              "stochMapDivisor": 4, "stochMapGuardBand": 512,
              "exponent": 2.0}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


def load_port():
    """Import the port from this checkout (never from an installed copy)."""
    sys.path.insert(0, str(ROOT))
    import rtsdm_tpu_torch
    where = Path(rtsdm_tpu_torch.__file__).resolve().parent.parent
    check(where == ROOT, f"rtsdm_tpu_torch imported from {where}, not from "
                         f"this checkout {ROOT}")
    check("jax" not in sys.modules, "the port imported jax")
    return rtsdm_tpu_torch


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


# ---------------------------------------------------------------------------
# kernel bookkeeping
# ---------------------------------------------------------------------------

class Kernel:
    """One CUDA kernel of a path: the keys its launches are counted under
    (rtsdm_tpu_torch._build.LAUNCHES), its wrapper, the (module, name)
    places the path looks the wrapper up under, its plain version(s), and
    the TPU kernel it replaces."""

    def __init__(self, name, entries, wrapper, lookups, plains, source,
                 replaces):
        self.name, self.entries = name, tuple(entries)
        self.wrapper, self.lookups = wrapper, list(lookups)
        self.plains = list(plains)
        self.source, self.replaces = source, replaces
        self.calls = []          # (args, kwargs) of the path's calls
        self.result = {}

    @property
    def launches(self) -> int:
        """Launches of the kernel, counted by the wrapper where it launches
        it (rtsdm_tpu_torch._build.launch)."""
        from rtsdm_tpu_torch._build import LAUNCHES
        return sum(LAUNCHES[e] for e in self.entries)


def kernels_of_path():
    from rtsdm_tpu_torch.ops import fetch_cuda, raster_cuda, rt_cuda
    from rtsdm_tpu_torch.passes import svao_shift
    return [
        Kernel("raster", ["rtsdm_raster_blocks"],
               raster_cuda.raster_blocks, [(raster_cuda, "raster_blocks")],
               [(raster_cuda, "raster_blocks_plain")],
               "rtsdm_tpu_torch/csrc/raster.cu",
               "rtsdm_tpu/ops/raster_pallas.py:394"),
        Kernel("fetch_attributes", ["rtsdm_fetch_attributes"],
               raster_cuda.fetch_attributes,
               [(raster_cuda, "fetch_attributes")],
               [(raster_cuda, "fetch_attributes_plain")],
               "rtsdm_tpu_torch/csrc/raster.cu",
               "rtsdm_tpu/ops/raster_pallas.py:584"),
        Kernel("fetch_all_directions", ["rtsdm_fetch_directions"],
               fetch_cuda.fetch_all_directions,
               [(svao_shift, "fetch_all_directions")],
               [(fetch_cuda, "fetch_all_directions_plain")],
               "rtsdm_tpu_torch/csrc/fetch.cu",
               "rtsdm_tpu/ops/fetch_pallas.py:221"),
        Kernel("fetch_sd_packed", ["rtsdm_fetch_sd_packed"],
               fetch_cuda.fetch_sd_packed,
               [(svao_shift, "fetch_sd_packed")],
               [(fetch_cuda, "fetch_sd_packed_plain")],
               "rtsdm_tpu_torch/csrc/fetch.cu",
               "rtsdm_tpu/ops/fetch_pallas.py:432"),
        Kernel("sd_trace", ["rtsdm_sd_trace"],
               rt_cuda.sd_trace_blocks, [(rt_cuda, "sd_trace_blocks")],
               [(rt_cuda, "sd_trace_blocks_plain")],
               "rtsdm_tpu_torch/csrc/sd_trace.cu",
               "rtsdm_tpu/ops/rt_pallas.py:791"),
    ]


def kernels_of_graph():
    """The SVAO path's five kernels plus K8 and K10, which the graph's
    RayShadow, EnvMapPass, ForwardLighting and TAA passes launch."""
    from rtsdm_tpu_torch.ops import rt_cuda, warp_cuda
    from rtsdm_tpu_torch.passes import temporal
    from rtsdm_tpu_torch.scene import textures
    return kernels_of_path() + [
        Kernel("any_hit", ["rtsdm_any_hit"], rt_cuda.any_hit_blocks,
               [(rt_cuda, "any_hit_blocks")],
               [(rt_cuda, "any_hit_blocks_plain")],
               "rtsdm_tpu_torch/csrc/any_hit.cu",
               "rtsdm_tpu/ops/rt_pallas.py:1068"),
        Kernel("warp_resample",
               [warp_cuda.launch_key(m) for m in warp_cuda.MODES],
               warp_cuda.warp_resample,
               [(textures, "warp_resample"), (temporal, "warp_resample")],
               [(warp_cuda, "warp_resample_plain"),
                (temporal, "warp_resample_plain")],
               "rtsdm_tpu_torch/csrc/warp.cu",
               "rtsdm_tpu/ops/warp_pallas.py:198"),
    ]


@contextlib.contextmanager
def record_main_path(kernels):
    """Keep the arguments of every kernel call the path makes, and fail
    any call of a plain version while the path runs."""
    saved = []
    plain_calls = []
    for k in kernels:
        for owner, attr in k.lookups:
            check(getattr(owner, attr) is k.wrapper,
                  f"{k.name}: the path does not look up its wrapper as "
                  f"{owner.__name__}.{attr}")

        def rec(*args, _k=k, **kwargs):
            _k.calls.append((args, kwargs))
            return _k.wrapper(*args, **kwargs)

        def plain_guard(*args, _k=k, **kwargs):
            plain_calls.append(_k.name)
            raise SmokeFailure(f"{_k.name}: the plain version ran on the "
                               "path")

        for owner, attr in k.lookups:
            saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, rec)
        for owner, attr in k.plains:
            saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, plain_guard)
    try:
        yield plain_calls
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def g_buffer_stage(scene, width, height):
    """G-buffer -> linear depth -> packed view-space face normals
    (bench.py:101-104)."""
    from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer
    from rtsdm_tpu_torch.utils.math import (encode_normal_2x16, normalize,
                                            transform_vector)
    cam = scene.camera
    g = raster_gbuffer(scene, width, height)
    lin = cam.linearize_depth(g["depth"])
    packed = encode_normal_2x16(normalize(
        transform_vector(cam.view_mat, g["faceNormalW"])))
    return g, lin, packed


def make_svao(scene, width, height, props):
    from rtsdm_tpu_torch.passes.svao import SVAO
    from rtsdm_tpu_torch.rendergraph.render_pass import RenderContext
    pass_ = SVAO(props)
    pass_.set_scene(scene)
    ctx = RenderContext(width=width, height=height, scene=scene,
                        dictionary={"guardBand": 0})
    return pass_, ctx


def frame(scene, pass_, ctx, width, height):
    g, lin, packed = g_buffer_stage(scene, width, height)
    out, _ = pass_.execute(ctx, {"gbufferDepth": g["depth"], "depth": lin,
                                 "normals": packed})
    return g, out


def check_frame(g, out, width, height, sd_map):
    import torch
    ao, stencil = out["ao"], out["stencil"]
    check(ao.shape == (height, width), f"AO shape {tuple(ao.shape)}")
    check(bool(torch.isfinite(ao).all()), "AO has non-finite values")
    lo, hi = float(ao.min()), float(ao.max())
    check(0.0 <= lo and hi <= 1.0, f"AO outside [0, 1]: [{lo}, {hi}]")
    check(lo < 0.9, f"AO shows no occlusion anywhere (min {lo})")
    cover = float((g["tri_id"] >= 0).float().mean())
    check(cover > 0.5, f"G-buffer covers {cover:.3f} of the frame")
    stencil_share = float((stencil != 0).float().mean())
    check(stencil_share > 0.0, "the stencil is empty: no direction asked "
                               "for the SD map")
    hit_share = float((sd_map < 1.0).any(-1).float().mean())
    check(hit_share > 0.0, "the SD map is empty")
    log(f"main path: AO in [{lo:.4f}, {hi:.4f}], mean "
        f"{float(ao.mean()):.4f}; G-buffer coverage {cover:.4f}; stencil "
        f"share {stencil_share:.4f}; SD texels with a hit {hit_share:.4f}")


def drive_main_path(scene, kernels):
    import torch
    pass_, ctx = make_svao(scene, WIDTH, HEIGHT, SVAO_PROPS)
    from rtsdm_tpu_torch._build import LAUNCHES
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with record_main_path(kernels) as plain_calls:
        g, out = frame(scene, pass_, ctx, WIDTH, HEIGHT)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    log(f"main path, first frame (host clock, kernel loading included): "
        f"{seconds:.3f} s; launches {counts}")
    check(not plain_calls, f"plain versions ran: {plain_calls}")
    for k in kernels:
        check(k.launches > 0, f"{k.name}: its kernel never launched on the "
                              "main path")
        check(k.calls, f"{k.name}: no recorded call")
    sd_map = kernels_by_name(kernels)["fetch_sd_packed"].calls[0][0][0]
    check_frame(g, out, WIDTH, HEIGHT, sd_map)
    return pass_, ctx, counts


def kernels_by_name(kernels):
    return {k.name: k for k in kernels}


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------

def _max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


# fp32 operations per unit of work, counted from the kernels' sources
RASTER_FLOPS_PER_TEST = 24    # raster.cu: five plane equations (4 each),
                              # the edge tolerance (3), the depth divide (1)
TRACE_FLOPS_PER_TEST = 18     # sd_trace.cu: det, u*det, v*det (5 each),
                              # u+v, the two interval products
ANY_HIT_FLOPS_PER_PAIR = 47   # any_hit.cu: d x e2 (9), det (5), o - v0 (3),
                              # u*det (5), tv x e1 (9), v*det (5), t*det (5),
                              # the sign products (4), the interval (2)


def nbytes(*objs) -> int:
    """Bytes of every tensor among objs (lists and tuples searched)."""
    total = 0
    for o in objs:
        if isinstance(o, (list, tuple)):
            total += nbytes(*o)
        elif hasattr(o, "element_size"):
            total += o.numel() * o.element_size()
    return total


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate (each input read once, each output
    written once) and the operations over the fp32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_bound(result: dict, n_bytes: float, flops: float,
               library_ms=None) -> dict:
    b_ms, b_by = bound(n_bytes, flops)
    return dict(result, bound_ms=b_ms, bound_by=b_by, bound_bytes=n_bytes,
                bound_flops=flops, library_ms=library_ms)


def walk_visits(lists, counts, n_chunks: int):
    """Chunks each tile's walk visits (a tile whose list overflowed visits
    every chunk), as float64."""
    return counts.clamp(max=lists.shape[1]).where(
        counts <= lists.shape[1], n_chunks).double()


def chunk_visits(lists, counts, n_chunks: int) -> str:
    """The work of a tile walk: chunks visited per tile."""
    visits = walk_visits(lists, counts, n_chunks)
    return (f"{counts.numel()} tiles visit {float(visits.mean()):.1f} chunks "
            f"on average (max {int(visits.max())}, {int(visits.sum())} in "
            f"all); {int((counts > lists.shape[1]).sum())} tiles overflow "
            f"their list of {lists.shape[1]}")


def compare_raster(k):
    """K1: bit-exact expected (--fmad=false and PyTorch both round every
    operation); bounded residual: tri_id differs on at most 1e-4 of the
    pixels, and where the ids agree depth and barycentrics agree to 1e-6."""
    import torch
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    args, kwargs = k.calls[0]
    got = RC.raster_blocks(*args, **kwargs)
    want = RC.raster_blocks_plain(*args, **kwargs)
    z, tid, b1, b2 = got
    same = tid == want[1]
    mism = int((~same).sum())
    err = max(_max_abs(x[same], y[same]) for x, y in
              ((z, want[0]), (b1, want[2]), (b2, want[3])))
    n = tid.numel()
    log(f"K1 raster {tuple(tid.shape)}, {args[0].shape[0]} chunks: tri_id "
        f"mismatches {mism} of {n}; max |diff| where ids agree {err:.3g} "
        f"(bounds: {int(1e-4 * n)} pixels, 1e-6)")
    log(f"K1 walk: {chunk_visits(args[1], args[2], args[0].shape[0])}")
    check(mism <= 1e-4 * n and err <= 1e-6, "K1 disagrees with its plain "
                                            "version")
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    tests = float(walk_visits(args[1], args[2], args[0].shape[0]).sum()) \
        * RC.TC * 256
    # no PyTorch call rasterizes triangles: no library yardstick
    return with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=exact,
             ms=cuda_ms(lambda: RC.raster_blocks(*args, **kwargs), 20, 2),
             plain_ms=cuda_ms(lambda: RC.raster_blocks_plain(*args,
                                                             **kwargs),
                              1, 1)),
        nbytes(args[:3], got), tests * RASTER_FLOPS_PER_TEST)


def compare_fetch_attributes(k):
    """K2: bit-exact (same products and sums in the same order)."""
    import torch
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    args, kwargs = k.calls[0]
    got = RC.fetch_attributes(*args, **kwargs)
    want = RC.fetch_attributes_plain(*args, **kwargs)
    err = _max_abs(got, want)
    log(f"K2 fetch_attributes {tuple(got.shape)}: max |diff| {err:.3g} "
        "(bound: bit-exact)")
    check(torch.equal(got, want), "K2 is not bit-exact")
    tri_id, nci = args[0], args[3]
    # b0 (2), then 3 products and 2 sums per interpolated component; no
    # single PyTorch call gathers and interpolates: no library yardstick
    flops = float((tri_id >= 0).sum()) * (2 + 5 * nci)
    return with_bound(
        dict(max_abs_err=err, mismatches=0, exact=True,
             ms=cuda_ms(lambda: RC.fetch_attributes(*args, **kwargs), 50, 3),
             plain_ms=cuda_ms(lambda: RC.fetch_attributes_plain(
                 *args, **kwargs), 10, 2)),
        nbytes(args[:3], got), flops)


def compare_fetch_directions(k):
    """K3: bit-exact (a copy selected by an fp32 level comparison)."""
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    args, kwargs = k.calls[0]
    sets, pad, radius, levels, offs, radii = args
    got = torch.stack(F.fetch_all_directions(*args, **kwargs))
    planes = torch.stack(list(sets)).contiguous()

    def plain():
        return F.fetch_all_directions_plain(planes, pad, radius, levels,
                                            offs, radii)

    want = torch.stack(plain())
    err = _max_abs(got, want)
    mism = int((got != want).sum())
    log(f"K3 fetch_all_directions {tuple(got.shape)}: {mism} mismatches, "
        f"max |diff| {err:.3g} (bound: bit-exact)")
    check(torch.equal(got, want), "K3 is not bit-exact")
    # a copy per output after one product radius * radii[d]; no single
    # PyTorch call selects the level and shifts: no library yardstick
    return with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=True,
             ms=cuda_ms(lambda: F.fetch_all_directions(*args, **kwargs),
                        50, 3),
             plain_ms=cuda_ms(plain, 5, 1)),
        nbytes(planes, radius, got), float(got.numel()))


def compare_fetch_sd_packed(k):
    """K4: bit-exact (an int32 copy)."""
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    args, kwargs = k.calls[0]
    sd_map, guard, radius, levels, offs, radii, pad = args
    got = F.fetch_sd_packed(*args, **kwargs)
    check(got is not None, "K4: the SD tables do not fit at the main path's "
                           "shape")
    sd_pl = F.pack_sd16(sd_map)

    def plain():
        return F.fetch_sd_packed_plain(sd_pl, guard, radius.contiguous(),
                                       levels, offs, radii)

    want = plain()
    mism = int((got != want).sum())
    err = max((_max_abs(F.unpack_sd16(got, kk), F.unpack_sd16(want, kk))
               for kk in range(sd_map.shape[-1])), default=0.0)
    log(f"K4 fetch_sd_packed {tuple(got.shape)}: {mism} mismatches, max "
        f"|diff| of the unpacked depths {err:.3g} (bound: bit-exact)")
    check(torch.equal(got, want), "K4 is not bit-exact")
    # as K3, on the 16-bit packed SD map: no library yardstick
    return with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=True,
             ms=cuda_ms(lambda: F.fetch_sd_packed(*args, **kwargs), 50, 3),
             plain_ms=cuda_ms(plain, 5, 1)),
        nbytes(sd_map, radius, got), float(got.numel()))


def compare_sd_trace(k):
    """K5: bit-exact expected (--fmad=false; the reservoir keeps the k
    smallest distinct values whatever the insertion order); bounded
    residual: at most 1e-4 of the rays differ. Also the key function on
    the INT_MIN hash, where |INT_MIN| stays negative (key 32765)."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    args, kwargs = k.calls[0]
    got = RT.sd_trace_blocks(*args, **kwargs)
    want = RT.sd_trace_blocks_plain(*args, **kwargs)
    bad = (got != want).any(1)
    mism = int(bad.sum())
    err = _max_abs(RT.decode_packed(got, 0.0, 1.0),
                   RT.decode_packed(want, 0.0, 1.0))
    n = got.shape[0]
    log(f"K5 sd_trace {n} rays x {got.shape[1]} slots, {args[0].shape[0]} "
        f"chunks: {mism} rays differ; max |diff| of the decoded depths "
        f"{err:.3g} (bound: {int(1e-4 * n)} rays)")
    log(f"K5 walk: {chunk_visits(args[1], args[2], args[0].shape[0])}; "
        f"rays with a hit {float((got != RT.INVALID).any(1).double().mean()):.4f}")
    check(mism <= 1e-4 * n, "K5 disagrees with its plain version")
    check(bool((got != RT.INVALID).any()), "K5 found no hit")

    dev = got.device
    hb = torch.tensor([-2**31, -2**31 + 1, -1, 0, 1, 32767, 2**31 - 1],
                      dtype=torch.int32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    u = torch.rand(4096, generator=gen)
    v = torch.rand(4096, generator=gen)
    hbs = hb.repeat(586)[:4096].cpu()
    key_uv, key_hb = RT.sd_keys(u.to(dev), v.to(dev), hbs.to(dev))
    want_uv, want_hb = RT.sd_keys(u, v, hbs)
    check(int(key_hb[0]) == 32765, f"key of INT_MIN is {int(key_hb[0])}")
    check(torch.equal(key_uv.cpu(), want_uv)
          and torch.equal(key_hb.cpu(), want_hb),
          "the trace kernel's key function disagrees with the plain one")
    log(f"K5 key function: INT_MIN -> {int(key_hb[0])}, 4096 (u, v) keys "
        "bit-exact")
    tests = float(walk_visits(args[1], args[2], args[0].shape[0]).sum()) \
        * RT.TC * RT.RB
    # no PyTorch call traces rays: no library yardstick
    return with_bound(
        dict(max_abs_err=err, mismatches=mism,
             exact=bool(torch.equal(got, want)),
             ms=cuda_ms(lambda: RT.sd_trace_blocks(*args, **kwargs), 10, 2),
             plain_ms=cuda_ms(lambda: RT.sd_trace_blocks_plain(
                 *args, **kwargs), 1, 1)),
        nbytes(args[:4], got), tests * TRACE_FLOPS_PER_TEST)


COMPARE = {"raster": compare_raster,
           "fetch_attributes": compare_fetch_attributes,
           "fetch_all_directions": compare_fetch_directions,
           "fetch_sd_packed": compare_fetch_sd_packed,
           "sd_trace": compare_sd_trace}


# ---------------------------------------------------------------------------
# steady-state stages
# ---------------------------------------------------------------------------

def staged_frame_ms(scene, pass_, ctx, reps: int = 5):
    """Per-stage device times of a steady-state frame (the mean over `reps`
    frames after the first): the stages SVAO.execute runs, called as it
    calls them, each between two CUDA events."""
    import torch
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.passes.svao import _normals_to_view
    from rtsdm_tpu_torch.passes.svao_shift import (svao_phase1_shift,
                                                   svao_phase2_shift)
    from rtsdm_tpu_torch.rendergraph.render_pass import RenderContext
    cam = scene.camera
    cfg = pass_._vao_cfg(ctx, (WIDTH, HEIGHT))
    sd_w, sd_h = pass_._stoch_map_size((WIDTH, HEIGHT))
    sd_ctx = RenderContext(width=sd_w, height=sd_h, scene=scene,
                           dictionary={"guardBand": 0})
    graph = pass_._build_sd_graph()
    names = ("g_buffer", "phase1", "sd_trace", "phase2", "frame")
    sums = dict.fromkeys(names, 0.0)
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        g, lin, packed = g_buffer_stage(scene, WIDTH, HEIGHT)
        ev[1].record()
        nv = _normals_to_view(ctx, packed)
        p1 = svao_phase1_shift(cam, cfg, lin, nv, 0, True)
        ev[2].record()
        marked, _, _ = graph.execute(sd_ctx, {}, external_inputs={
            "StochasticDepthMap.linearZ": lin,
            "StochasticDepthMap.depthMap": g["depth"],
            "StochasticDepthMap.rayMin": p1["ray_min"],
            "StochasticDepthMap.rayMax": p1["ray_max"]})
        sd_map = marked["StochasticDepthMap.stochasticDepth"]
        ev[3].record()
        delta = svao_phase2_shift(cam, cfg, lin, nv, p1["stencil"], sd_map,
                                  True, 4)
        ao = torch.where(p1["stencil"] != 0,
                         A.finalize(cfg, p1["ao_raw"] + delta),
                         A.finalize(cfg, p1["ao_raw"]))
        ev[4].record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(ao).all()), "staged AO is not finite")
        if r == 0:
            continue
        for i, n in enumerate(names[:4]):
            sums[n] += ev[i].elapsed_time(ev[i + 1])
        sums["frame"] += ev[0].elapsed_time(ev[4])
    return {n: sums[n] / reps for n in names}


# device symbol of each kernel (csrc/*.cu), as the profiler names it
KERNEL_SYMBOLS = {"raster": "raster_blocks_kernel",
                  "fetch_attributes": "fetch_attributes_kernel",
                  "fetch_all_directions": "fetch_directions_kernel",
                  "fetch_sd_packed": "fetch_sd_packed_kernel",
                  "sd_trace": "sd_trace_kernel",
                  "any_hit": "any_hit_kernel",
                  "warp_resample": "warp_resample_kernel",
                  "fetch_taps_same_class": "fetch_taps_same_class_kernel",
                  "raster_stochastic": "raster_sd_kernel",
                  "sd_trace_resident": "sd_trace_resident_kernel"}


def profiled_frame(scene, pass_, ctx):
    """Device activity of one steady-state frame under torch.profiler:
    {name: (ms, count)} over every kernel, copy and fill the card ran.
    Empty where the profiler saw no device activity."""
    return profiled(lambda: frame(scene, pass_, ctx, WIDTH, HEIGHT))


def profiled(run_frame):
    """Device activity of run_frame() (after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_frame()
        torch.cuda.synchronize()
    acts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = acts.get(e.name, (0.0, 0))
            acts[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    return acts


def kernel_device_ms(acts, name: str):
    """Summed device time of kernel `name` in a profiled frame, or None."""
    hits = [ms for k, (ms, _) in acts.items() if KERNEL_SYMBOLS[name] in k]
    return sum(hits) if hits else None


def frame_host_ms(scene, pass_, ctx, reps: int = 5) -> float:
    """Host-clock time of whole frames through the public entry points,
    ending in a synchronize (mean over `reps` after one warm frame)."""
    import torch
    frame(scene, pass_, ctx, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        frame(scene, pass_, ctx, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# ---------------------------------------------------------------------------
# small reference frame: card against the CPU tier
# ---------------------------------------------------------------------------

def small_frame_against_cpu():
    """CornellBox 64x64 through the same path on the card and on the CPU.
    The CPU run takes the plain versions, which tests/test_torch_*.py hold
    against the JAX package; the bound is theirs (tests/test_svao.py:
    160-162): |AO diff| < 2e-2 everywhere and < 1e-4 on >= 98% of pixels,
    tri_id equal on >= 99.9%."""
    import torch
    from rtsdm_tpu_torch.scene.procedural import cornell_box
    props = {**SVAO_PROPS, "radius": 0.5, "stochMapGuardBand": 32,
             "sampleCount": 4, "stochSamples": 2}
    res = {}
    for dev in ("cuda", "cpu"):
        scene = cornell_box(device=dev)
        pass_, ctx = make_svao(scene, 64, 64, props)
        g, out = frame(scene, pass_, ctx, 64, 64)
        res[dev] = (g["tri_id"].cpu(), out["ao"].cpu())
    same = res["cuda"][0] == res["cpu"][0]
    diff = (res["cuda"][1] - res["cpu"][1]).abs()
    share = float((diff < 1e-4).float().mean())
    log(f"CornellBox 64x64, card vs CPU: tri_id equal on "
        f"{float(same.float().mean()):.5f}; max |AO diff| "
        f"{float(diff.max()):.3g}; share < 1e-4: {share:.5f}")
    check(float(same.float().mean()) >= 0.999, "tri_id differs")
    check(float(diff.max()) < 2e-2 and share >= 0.98,
          "AO on the card differs from the CPU tier")
    check(bool(torch.isfinite(res["cuda"][1]).all()), "AO not finite")



# ---------------------------------------------------------------------------
# the graph path: scripts/SVAO_small.py through the port's Mogwai harness
# ---------------------------------------------------------------------------

GRAPH_OUTPUTS = ("ShadedTAA.colorOut", "AmbientOcclusionTAA.colorOut",
                 "Shaded.out", "AmbientOcclusion.out")
ANY_HIT_TILES = 128   # whole 8x32 tiles of K8's plain comparison


def graph_renderer():
    """The `m` of a Mogwai run of the script: Renderer, script, scene,
    paused clock (the script's own properties, nothing overridden)."""
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = Renderer(WIDTH, HEIGHT, device="cuda")
    run_script(str(GRAPH_SCRIPT), m)
    m.loadScene(GRAPH_SCENE)
    m.clock.pause()
    return m


def check_graph_outputs(out):
    import torch
    check(set(out) == set(GRAPH_OUTPUTS), f"marked outputs {sorted(out)}")
    for name in GRAPH_OUTPUTS:
        v = out[name]
        check(v.shape[:2] == (HEIGHT, WIDTH), f"{name}: shape "
                                              f"{tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), f"{name}: non-finite values")
    ao = out["AmbientOcclusion.out"][..., 0]
    lo, hi = float(ao.min()), float(ao.max())
    check(0.0 <= lo and hi <= 1.0, f"AO outside [0, 1]: [{lo}, {hi}]")
    check(lo < 0.9, f"AO shows no occlusion anywhere (min {lo})")
    shaded = out["Shaded.out"][..., :3]
    check(float(shaded.max()) > 0.0, "the shaded image is black")
    return lo, hi


def drive_graph(kernels, path_counts):
    """Run the graph for GRAPH_FRAMES frames; counts are zeroed just before
    and read just after every frame. Returns (renderer, launches summed over
    the frames, K10's launches by mode)."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import warp_cuda
    t0 = time.perf_counter()
    m = graph_renderer()
    n_lights = min(int(m.scene.num_lights), int(
        m.active_graph.get_pass("RayShadow").cfg["maxLights"]))
    log(f"graph: {GRAPH_SCRIPT.relative_to(ROOT)} on {GRAPH_SCENE} "
        f"({m.scene.num_triangles} triangles, {n_lights} light(s)) at "
        f"{WIDTH}x{HEIGHT}, set up in {time.perf_counter() - t0:.2f} s")
    want = {"raster": 2 * path_counts["raster"],
            "fetch_attributes": 2 * path_counts["fetch_attributes"],
            "fetch_all_directions": path_counts["fetch_all_directions"],
            "fetch_sd_packed": path_counts["fetch_sd_packed"],
            "sd_trace": path_counts["sd_trace"],
            "any_hit": n_lights}
    totals = collections.Counter()
    modes = collections.Counter()
    with record_main_path(kernels) as plain_calls:
        for f in range(GRAPH_FRAMES):
            m.clock.frame = f
            for k in kernels:
                k.calls.clear()        # keep the last frame's inputs
            torch.cuda.synchronize()
            LAUNCHES.clear()
            out = m.renderFrame()
            counts = {k.name: k.launches for k in kernels}
            by_mode = {md: LAUNCHES[warp_cuda.launch_key(md)]
                       for md in warp_cuda.MODES}
            lo, hi = check_graph_outputs(out)
            log(f"graph frame {f}: {m.last_frame_ms:.3f} ms host clock; "
                f"launches {counts}; K10 by mode {by_mode}; AO in "
                f"[{lo:.4f}, {hi:.4f}]")
            check(not plain_calls, f"plain versions ran: {plain_calls}")
            for name, n in want.items():
                check(counts[name] == n, f"{name}: {counts[name]} launches "
                                         f"in a graph frame, expected {n}")
            check(counts["warp_resample"] >= 6, "K10 launched fewer than 6 "
                                                "times in a graph frame")
            check(by_mode["catmull_rom"] == 2, "K10: TAA x2 expected")
            totals.update(counts)
            modes.update(by_mode)
    return m, dict(totals), dict(modes)


def any_hit_subset(tri, lists, counts, rays):
    """(sel, inputs): up to ANY_HIT_TILES whole 8x32 tiles spread evenly
    over the tiles that hold a live ray, and K8's inputs cut to them."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    nb = counts.shape[0]
    live = (rays[7] > rays[6]).reshape(nb, RT.RB)
    live_tiles = torch.nonzero(live.any(1)).squeeze(1)
    check(live_tiles.numel() > 0, "K8: no live ray")
    pick = torch.linspace(0, live_tiles.numel() - 1,
                          min(ANY_HIT_TILES, live_tiles.numel()),
                          device=live.device).round().long().unique()
    sel = live_tiles[pick]
    return sel, (tri, lists[sel].contiguous(), counts[sel].contiguous(),
                 rays.reshape(8, nb, RT.RB)[:, sel].reshape(8, -1)
                 .contiguous())


def compare_any_hit(k):
    """K8: bit-exact, hits and the pairs each ray tested, on ANY_HIT_TILES
    whole 8x32 tiles spread evenly over the tiles of the graph's last frame
    that hold a live ray (the plain version over all 2.47M rays would take
    too long); the kernel's launch over every tile must give the same
    answers on those tiles as its launch on the subset. The bound counts
    the ray-triangle pairs this run needed: each ray's pairs up to and
    including its first hit, as the kernel reports them for every ray."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    check(len(k.calls) >= 1, "K8: no recorded call")
    (tri, lists, counts, rays), kwargs = k.calls[-1]
    nb = counts.shape[0]
    hit, pairs = RT.any_hit_blocks(tri, lists, counts, rays)
    live = (rays[7] > rays[6]).reshape(nb, RT.RB)
    sel, sub = any_hit_subset(tri, lists, counts, rays)
    hit_s, pairs_s = RT.any_hit_blocks(*sub)
    hit_p, pairs_p = RT.any_hit_blocks_plain(*sub)
    mism = int((hit_s != hit_p).sum()) + int((pairs_s != pairs_p).sum())
    err = float((hit_s.double() - hit_p.double()).abs().max())
    n_live = int(live.sum())
    hit_share = float(hit.reshape(nb, RT.RB)[live].double().mean())
    # the chunks a tile walked: the most of its rays' pairs over 128
    vis = torch.div(pairs.reshape(nb, RT.RB).amax(1) + RT.TC - 1, RT.TC,
                    rounding_mode="floor").double()
    n_pairs = float(pairs.double().sum())
    walk_pairs = float((vis * live.sum(1).double()).sum()) * RT.TC
    log(f"K8 any_hit {nb * RT.RB} rays ({n_live} live) x {tri.shape[0]} "
        f"chunks: {hit_share:.4f} of live rays occluded; tiles walk "
        f"{float(vis.mean()):.1f} chunks on average (max {int(vis.max())}, "
        f"{int(vis.sum())} in all); {n_pairs:.6g} ray-triangle pairs tested "
        f"({walk_pairs:.6g} if every live ray tested its tile's whole walk)")
    log(f"K8 against its plain version on {sel.numel()} tiles "
        f"({int(live[sel].sum())} live rays): {mism} mismatches of hits "
        "and tested pairs (bound: bit-exact)")
    check(mism == 0, "K8 disagrees with its plain version")
    check(torch.equal(hit.reshape(nb, RT.RB)[sel].reshape(-1), hit_s)
          and torch.equal(pairs.reshape(nb, RT.RB)[sel].reshape(-1),
                          pairs_s),
          "K8 over every tile disagrees with K8 over the subset")
    check(0.0 < hit_share < 1.0, f"K8: occluded share {hit_share}")
    ms = cuda_ms(lambda: RT.any_hit_blocks(tri, lists, counts, rays), 10, 2)
    ms_sub = cuda_ms(lambda: RT.any_hit_blocks(*sub), 10, 2)
    plain_ms = cuda_ms(lambda: RT.any_hit_blocks_plain(*sub), 1, 0)
    log(f"K8 times: kernel {ms:.4f} ms over every tile; on the "
        f"{sel.numel()} tiles kernel {ms_sub:.4f} ms, plain {plain_ms:.2f} "
        "ms")
    # no PyTorch call traces rays: no library yardstick
    return [dict(with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=True, ms=ms,
             plain_ms=plain_ms, ms_on_plain_tiles=ms_sub,
             plain_on=f"{sel.numel()} of {nb} tiles",
             pairs=n_pairs, walk_pairs=walk_pairs,
             chunk_visits=int(vis.sum())),
        nbytes(tri, lists, counts, rays, hit, pairs),
        n_pairs * ANY_HIT_FLOPS_PER_PAIR), name="any_hit")]


# fp32 operations of K10 per output pixel and per output value, counted
# from warp.cu (bilinear: the tap position and fractions, then three lerps
# per channel; Catmull-Rom: both axes' weights, nine tap positions through
# the uv round trip, then nine weighted blends per channel)
WARP_FLOPS = {"bilinear": (4, 12), "catmull_rom": (131, 126)}


def _warp_args(args, kwargs):
    from rtsdm_tpu_torch.ops import warp_cuda as W
    b = inspect.signature(W.warp_resample).bind(*args, **kwargs)
    b.apply_defaults()
    return b.arguments


def warp_bound(tex, sx, sy, out, mode):
    per_px, per_val = WARP_FLOPS[mode]
    flops = sx.numel() * per_px + out.numel() * per_val
    return nbytes(tex, sx, sy, out), float(flops)


def compare_warp(k, launches_by_mode):
    """K10: bit-exact on every call of the graph's last frame (TAA x2
    Catmull-Rom, env map x3 bilinear wrapped in x, texture pages x1
    bilinear), and on a synthetic motion field at the TAA shape (the real
    history texture, +-6 px of sin/cos motion, then the same field shifted
    far out of bounds by (+500, -300) px, as tests/test_pallas_interpret.py
    builds it). The timed rows use the smooth field at the TAA shape;
    bilinear's library yardstick is grid_sample (border, align_corners
    False), which no part of the port calls."""
    import torch
    from rtsdm_tpu_torch.ops import warp_cuda as W
    check(k.calls, "K10: no recorded call")
    taa = None
    worst = 0.0
    for args, kwargs in k.calls:
        a = _warp_args(args, kwargs)
        got = W.warp_resample(**a)
        want = W.warp_resample_plain(**a)
        err = _max_abs(got, want)
        worst = max(worst, err)
        log(f"K10 {a['mode']}{' wrap_x' if a['wrap_x'] else ''} "
            f"{tuple(a['tex'].shape)} -> {tuple(got.shape)}: max |diff| "
            f"{err:.3g} (bound: bit-exact); kernel "
            f"{cuda_ms(lambda: W.warp_resample(**a), 20, 2):.4f} ms")
        check(torch.equal(got, want), "K10 is not bit-exact on the path")
        if a["mode"] == "catmull_rom":
            taa = a["tex"]
    check(taa is not None, "K10: no TAA call recorded")
    c, h, w = taa.shape
    dev = taa.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev)
                            + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev)
                            + 0.5, indexing="ij")
    mx = 6.0 * torch.sin(torch.linspace(0.0, 3.0, w, device=dev))[None, :]
    my = 6.0 * torch.cos(torch.linspace(0.0, 2.0, h, device=dev))[:, None]
    sx, sy = (xs + mx).contiguous(), (ys + my).contiguous()
    fields = {"smooth": (sx, sy),
              "far": ((sx + 500.0).contiguous(), (sy - 300.0).contiguous())}
    rows = []
    for mode in ("catmull_rom", "bilinear"):
        for fname, (fx, fy) in fields.items():
            got = W.warp_resample(taa, fx, fy, mode)
            want = W.warp_resample_plain(taa, fx, fy, mode)
            err = _max_abs(got, want)
            worst = max(worst, err)
            log(f"K10 {mode} on the {fname} synthetic field "
                f"{tuple(taa.shape)}: max |diff| {err:.3g} (bound: "
                "bit-exact)")
            check(torch.equal(got, want),
                  f"K10 {mode} is not bit-exact on the {fname} field")
        out = W.warp_resample(taa, sx, sy, mode)
        ms = cuda_ms(lambda: W.warp_resample(taa, sx, sy, mode), 50, 3)
        plain_ms = cuda_ms(lambda: W.warp_resample_plain(taa, sx, sy, mode),
                           5, 1)
        library_ms = None
        if mode == "bilinear":
            grid = torch.stack([sx / w * 2.0 - 1.0, sy / h * 2.0 - 1.0],
                               -1)[None]
            tex4 = taa[None]

            def library():
                return torch.nn.functional.grid_sample(
                    tex4, grid, mode="bilinear", padding_mode="border",
                    align_corners=False)
            lib_err = _max_abs(library()[0], out)
            library_ms = cuda_ms(library, 50, 3)
            log(f"K10 bilinear yardstick grid_sample: {library_ms:.4f} ms; "
                f"max |diff| from K10 {lib_err:.3g} (not used by the port)")
        n_bytes, flops = warp_bound(taa, sx, sy, out, mode)
        rows.append(dict(with_bound(
            dict(max_abs_err=worst, mismatches=0, exact=True, ms=ms,
                 plain_ms=plain_ms, timed_at=f"{tuple(taa.shape)}, "
                 "synthetic motion"), n_bytes, flops, library_ms),
            name=f"warp_resample:{mode}",
            launches=launches_by_mode.get(mode, 0)))
        log(f"K10 {mode} at the TAA shape: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
    return rows


def graph_timing(m, reps: int = 7):
    """Host-clock median of `reps` steady frames (after a warm-up), the
    per-pass CUDA-event spans of one more frame, and one profiled frame."""
    import statistics

    import torch
    graph = m.active_graph
    m.renderFrame()
    host = []
    for _ in range(reps):
        m.renderFrame()
        host.append(m.last_frame_ms)
    graph.time_passes = True
    m.renderFrame()
    passes = graph.pass_times_ms()
    graph.time_passes = False
    acts = profiled(m.renderFrame)
    torch.cuda.synchronize()
    median = statistics.median(host)
    busy = sum(ms for ms, _ in acts.values()) if acts else None
    log(f"graph frame, host clock over {reps} frames (ms): "
        + ", ".join(f"{t:.3f}" for t in host) + f"; median {median:.3f}")
    log("graph frame, per pass (CUDA events, ms): " + ", ".join(
        f"{n} {t:.3f}" for n, t in passes.items()))
    if acts:
        log(f"graph profiled frame: {sum(n for _, n in acts.values())} "
            f"device activities, {busy:.3f} ms busy; device idle share of "
            f"the median host-clock frame {1.0 - busy / median:.4f}")
        for name, (ms, n) in sorted(acts.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
            log(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")
    else:
        log("graph profiled frame: the profiler saw no device activity; "
            "device busy time not measured")
    return dict(host_ms=host, host_median_ms=median, passes_ms=passes,
                device_busy_ms=busy,
                idle_share=None if busy is None else 1.0 - busy / median,
                kernel_device_ms={n: kernel_device_ms(acts, n)
                                  for n in KERNEL_SYMBOLS}), acts


# ---------------------------------------------------------------------------
# BASELINE configs 1 and 2 (bench_configs.py:17-23) through the harness
# ---------------------------------------------------------------------------

HBAO_SCRIPT = ROOT / "scripts" / "HBAO.py"
SVAO_FULL_SCRIPT = ROOT / "scripts" / "SVAO.py"
SVAO_FULL_OUTPUTS = ("AmbientRef.out", "DiffuseRef.out", "AmbientTAA.colorOut",
                     "DiffuseTAA.colorOut", "DiffuseDLSS.output")
CONFIG_FRAMES = 3
RASTER_SD = {"SVAO": {"stochasticDepthImpl": "Raster"}}
# label: (script, scene, width, height, pass overrides, marked outputs)
CONFIGS = {
    "config2": (GRAPH_SCRIPT, "Arcade@full", 1280, 720, RASTER_SD,
                GRAPH_OUTPUTS),
    "config1": (HBAO_SCRIPT, "CornellBox", 256, 256, {},
                ("Ambient.out", "Diffuse.out")),
    "config1_suntemple": (HBAO_SCRIPT, "SunTemple@full", 1920, 1080, {},
                          ("Ambient.out", "Diffuse.out")),
    "svao_full": (SVAO_FULL_SCRIPT, "Arcade@full", 1280, 720, {},
                  SVAO_FULL_OUTPUTS),
}
# each graph's AO output (its first channel is checked to lie in [0, 1])
AO_OUTPUT = {"config2": "AmbientOcclusion.out", "config1": "Ambient.out",
             "config1_suntemple": "Ambient.out", "svao_full": "AmbientRef.out"}
FLOOR = "raster:floor"          # K1 launched with its depth floor
RASTER_SD_FLOPS_PER_PAIR = 16   # raster_sd.cu: the three edge functions
                                # and the w plane (4 each), evaluated for
                                # every pixel-triangle pair; the tail of
                                # fragments inside is not counted


def kernels_of_configs():
    """Every kernel of the graph path plus K6 (HBAO's same-class fetch), K9
    (the raster stochastic depth map) and K7 (the resident SD trace)."""
    from rtsdm_tpu_torch.ops import fetch_cuda, raster_cuda, rt_cuda
    from rtsdm_tpu_torch.passes import hbao
    return kernels_of_graph() + [
        Kernel("fetch_taps_same_class", ["rtsdm_fetch_taps_same_class"],
               fetch_cuda.fetch_taps_same_class,
               [(hbao, "fetch_taps_same_class")],
               [(fetch_cuda, "fetch_taps_same_class_plain")],
               "rtsdm_tpu_torch/csrc/fetch.cu",
               "rtsdm_tpu/ops/fetch_pallas.py:264"),
        Kernel("raster_stochastic", ["rtsdm_raster_stochastic"],
               raster_cuda.raster_stochastic_blocks,
               [(raster_cuda, "raster_stochastic_blocks")],
               [(raster_cuda, "raster_stochastic_blocks_plain")],
               "rtsdm_tpu_torch/csrc/raster_sd.cu",
               "rtsdm_tpu/ops/raster_pallas.py:319"),
        Kernel("sd_trace_resident", ["rtsdm_sd_trace_resident"],
               rt_cuda.sd_trace_resident_blocks,
               [(rt_cuda, "sd_trace_resident_blocks")],
               [(rt_cuda, "sd_trace_resident_blocks_plain")],
               "rtsdm_tpu_torch/csrc/sd_trace.cu",
               "rtsdm_tpu/ops/rt_pallas.py:371"),
    ]


def config_renderer(label):
    """The `m` of a Mogwai run of the config: Renderer, script, the
    config's pass overrides (as bench_configs.py sets them, after the graph
    was built), scene, paused clock."""
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    script, scene, width, height, overrides, _ = CONFIGS[label]
    m = Renderer(width, height, device="cuda")
    run_script(str(script), m)
    for pname, props in overrides.items():
        m.active_graph.get_pass(pname).cfg.update(props)
    m.loadScene(scene)
    m.clock.pause()
    return m


def check_config_outputs(label, out):
    import torch
    _, _, width, height, _, names = CONFIGS[label]
    check(set(out) == set(names), f"{label}: marked outputs {sorted(out)}")
    for name in names:
        v = out[name]
        check(v.shape[:2] == (height, width),
              f"{label} {name}: shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), f"{label} {name}: non-finite")
    ao = out[AO_OUTPUT[label]][..., 0]
    lo, hi = float(ao.min()), float(ao.max())
    check(0.0 <= lo and hi <= 1.0, f"{label}: AO outside [0, 1]: "
                                   f"[{lo}, {hi}]")
    check(lo < 0.9, f"{label}: AO shows no occlusion anywhere (min {lo})")
    return lo, hi


def config_want(label, n_lights):
    """Launches per frame that each config's graph must make."""
    if label in ("config2", "svao_full"):
        # G-buffer and ForwardLighting raster; SVAO phase 1 fetches both
        # ring halves, phase 2 reads the packed SD map; config 2 rasters
        # its SD map (K9), SVAO.py traces it resident (K7: Arcade's 38,610
        # triangles are at most 65,536); K5 never
        sd9 = int(label == "config2")
        return {"raster": 2, FLOOR: 0, "fetch_attributes": 2,
                "fetch_all_directions": 2, "fetch_sd_packed": 1,
                "sd_trace": 0, "raster_stochastic": sd9,
                "sd_trace_resident": 1 - sd9,
                "fetch_taps_same_class": 0, "any_hit": n_lights}
    # HBAO.py: G-buffer and ForwardLighting raster, DepthPeeling's floored
    # raster (live: HBAO reads depth2), one K6 call for the whole ring
    return {"raster": 2, FLOOR: 1, "fetch_attributes": 2,
            "fetch_all_directions": 0, "fetch_sd_packed": 0, "sd_trace": 0,
            "raster_stochastic": 0, "sd_trace_resident": 0,
            "fetch_taps_same_class": 1, "any_hit": n_lights}


def drive_config(label, kernels):
    """Run a config for CONFIG_FRAMES frames; counts are zeroed just before
    and read just after every frame, and no plain version may run. Returns
    (renderer, launches summed over the frames, K10's by mode)."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import raster_cuda, warp_cuda
    script, scene, width, height, overrides, _ = CONFIGS[label]
    t0 = time.perf_counter()
    m = config_renderer(label)
    n_lights = min(int(m.scene.num_lights), int(
        m.active_graph.get_pass("RayShadow").cfg["maxLights"]))
    log(f"{label}: {script.relative_to(ROOT)} {overrides or ''} on {scene} "
        f"({m.scene.num_triangles} triangles, {n_lights} light(s)) at "
        f"{width}x{height}, set up in {time.perf_counter() - t0:.2f} s")
    want = config_want(label, n_lights)
    totals = collections.Counter()
    modes = collections.Counter()
    with record_main_path(kernels) as plain_calls:
        for f in range(CONFIG_FRAMES):
            m.clock.frame = f
            for k in kernels:
                k.calls.clear()        # keep the last frame's inputs
            torch.cuda.synchronize()
            LAUNCHES.clear()
            out = m.renderFrame()
            counts = {k.name: k.launches for k in kernels}
            counts[FLOOR] = LAUNCHES[raster_cuda.RASTER_FLOOR_KEY]
            by_mode = {md: LAUNCHES[warp_cuda.launch_key(md)]
                       for md in warp_cuda.MODES}
            lo, hi = check_config_outputs(label, out)
            log(f"{label} frame {f}: {m.last_frame_ms:.3f} ms host clock; "
                f"launches {counts}; K10 by mode {by_mode}; AO in "
                f"[{lo:.4f}, {hi:.4f}]")
            check(not plain_calls, f"plain versions ran: {plain_calls}")
            for name, n in want.items():
                check(counts[name] == n, f"{label}: {name} launched "
                                         f"{counts[name]} times in a frame, "
                                         f"expected {n}")
            if label in ("config2", "svao_full"):
                check(by_mode["catmull_rom"] == 2, "K10: TAA x2 expected")
            else:
                check(by_mode["catmull_rom"] == 0, "K10: HBAO.py has no TAA")
            totals.update(counts)
            modes.update(by_mode)
    return m, dict(totals), dict(modes)


def _pair_raster(args, kwargs):
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    return (RC.raster_blocks(*args, **kwargs),
            RC.raster_blocks_plain(*args, **kwargs))


def _pair_fetch_attributes(args, kwargs):
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    return ((RC.fetch_attributes(*args, **kwargs),),
            (RC.fetch_attributes_plain(*args, **kwargs),))


def _pair_fetch_directions(args, kwargs):
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    sets, pad, radius, levels, offs, radii = args
    planes = torch.stack(list(sets)).contiguous()
    return ((torch.stack(F.fetch_all_directions(*args, **kwargs)),),
            (torch.stack(F.fetch_all_directions_plain(
                planes, pad, radius.contiguous(), levels, offs, radii)),))


def _pair_fetch_sd_packed(args, kwargs):
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    sd_map, guard, radius, levels, offs, radii, pad = args
    got = F.fetch_sd_packed(*args, **kwargs)
    check(got is not None, f"K4: the SD tables do not fit (guard {guard})")
    return (got,), (F.fetch_sd_packed_plain(
        F.pack_sd16(sd_map), guard, radius.contiguous(), levels, offs,
        radii),)


def _pair_any_hit(args, kwargs):
    """On the spread tile subset (any_hit_subset): the plain version there,
    and the launch over every tile cut to the subset."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    tri, lists, counts, rays = args
    nb = counts.shape[0]
    full = RT.any_hit_blocks(*args, **kwargs)
    sel, sub = any_hit_subset(tri, lists, counts, rays)
    got = RT.any_hit_blocks(*sub)
    return (got + tuple(a.reshape(nb, RT.RB)[sel].reshape(-1)
                        for a in full),
            RT.any_hit_blocks_plain(*sub) + got)


def _pair_sd_trace_resident(args, kwargs):
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    return ((RT.sd_trace_resident_blocks(*args, **kwargs),),
            (RT.sd_trace_resident_blocks_plain(*args, **kwargs),))


def _pair_warp(args, kwargs):
    from rtsdm_tpu_torch.ops import warp_cuda as W
    a = _warp_args(args, kwargs)
    return (W.warp_resample(**a),), (W.warp_resample_plain(**a),)


# kernel -> (args, kwargs) -> (kernel outputs, plain outputs), for the
# configs' last-frame check; K6 and K9 are held by their own phases, K5 by
# the SD phases of SVAO.py
CONFIG_PAIRS = {"raster": _pair_raster,
                "fetch_attributes": _pair_fetch_attributes,
                "fetch_all_directions": _pair_fetch_directions,
                "fetch_sd_packed": _pair_fetch_sd_packed,
                "any_hit": _pair_any_hit,
                "warp_resample": _pair_warp,
                "sd_trace_resident": _pair_sd_trace_resident}


def check_config_calls(label, kernels):
    """Every call of the config's last frame, at the config's own shapes
    and settings (K1 with and without its floor, K4 at guard 0 in config 2,
    K7 in SVAO.py),
    against its plain version on the card: bit-exact (--fmad=false, the
    plain versions' operation order; K8 on a spread subset of whole tiles,
    as in compare_any_hit). Returns {kernel: calls held}."""
    import torch
    by_name = kernels_by_name(kernels)
    held = {}
    for name, pair in CONFIG_PAIRS.items():
        calls = by_name[name].calls
        for args, kwargs in calls:
            got, want = pair(args, kwargs)
            for g, w in zip(got, want):
                check(g.shape == w.shape, f"{label}: {name} output shape "
                                          f"{tuple(g.shape)} vs plain "
                                          f"{tuple(w.shape)}")
                mism = int((g != w).sum())
                check(torch.equal(g, w), f"{label}: {name} at "
                                         f"{tuple(g.shape)} is not "
                                         f"bit-exact ({mism} mismatches)")
        held[name] = len(calls)
    log(f"{label}: the last frame's calls held bit-exact against their plain "
        f"versions: {held}")
    return held


def compare_raster_floor(calls):
    """K1 with its depth floor (DepthPeeling) on the last floored call:
    times, bound, the share of pixels holding a second layer. Every floored
    call was held bit-exact by check_config_calls (--fmad=false; the floor
    test is a true division and a comparison)."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    floored = [(a, kw) for a, kw in calls if kw.get("floor") is not None]
    check(floored, "K1: no floored call recorded")
    args, kwargs = floored[-1]
    got = RC.raster_blocks(*args, **kwargs)
    peeled = float((got[1] >= 0).double().mean())
    log(f"K1 with floor {tuple(got[1].shape)}, {args[0].shape[0]} chunks, "
        f"min_separation {kwargs.get('min_separation')}: second-layer "
        f"coverage {peeled:.4f}")
    tests = float(walk_visits(args[1], args[2], args[0].shape[0]).sum()) \
        * RC.TC * 256
    # no PyTorch call rasterizes triangles: no library yardstick
    return with_bound(
        dict(max_abs_err=0.0, mismatches=0, exact=True,
             ms=cuda_ms(lambda: RC.raster_blocks(*args, **kwargs), 20, 2),
             plain_ms=cuda_ms(lambda: RC.raster_blocks_plain(*args,
                                                             **kwargs), 1, 1),
             timed_at=f"{tuple(got[1].shape)}", second_layer=peeled),
        nbytes(args[:3], kwargs["floor"], got),
        tests * RASTER_FLOPS_PER_TEST)


def compare_taps_same_class(calls, timed_label):
    """K6: bit-exact (a copy chosen by a table lookup) on every call kept
    from the configs' last frames; the timed row is the largest call."""
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    check(calls, "K6: no recorded call")
    worst = None
    for args, kwargs in calls:
        got = F.fetch_taps_same_class(*args, **kwargs)
        want = F.fetch_taps_same_class_plain(*args, **kwargs)
        mism = int((got != want).sum())
        log(f"K6 fetch_taps_same_class {tuple(args[0].shape)} -> "
            f"{tuple(got.shape)}: {mism} mismatches (bound: bit-exact)")
        check(torch.equal(got, want), "K6 is not bit-exact")
        if worst is None or got.numel() > worst[2].numel():
            worst = (args, kwargs, got)
    args, kwargs, got = worst
    planes, lvl, pad, offs = args
    tab = F._same_class_table_on(offs, pad, planes.device)
    # a copy per output; no single PyTorch call looks the offset up and
    # gathers (torch.gather needs the flat index this kernel computes): no
    # library yardstick
    return with_bound(
        dict(max_abs_err=0.0, mismatches=0, exact=True,
             ms=cuda_ms(lambda: F.fetch_taps_same_class(*args, **kwargs),
                        50, 3),
             plain_ms=cuda_ms(lambda: F.fetch_taps_same_class_plain(
                 *args, **kwargs), 5, 1),
             timed_at=f"{timed_label} {tuple(got.shape)}"),
        nbytes(planes, lvl, tab, got), 0.0)


def compare_raster_stochastic(k):
    """K9: bit-exact at the path's inputs (the last frame's call), at the
    path's alpha and at alpha 1.0 (every fragment writes floor(k + rng)
    slots), and on the same tiles with short lists that stream every
    chunk. The bound counts the pixel-triangle pairs of this run's walk."""
    import torch
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    check(k.calls, "K9: no recorded call")
    args, kwargs = k.calls[-1]
    chunks, lists, counts, nby, nbx, first, rmin, rmax, kk, alpha = args
    got = RC.raster_stochastic_blocks(*args, **kwargs)
    hit = float((got < RC.SD_EMPTY).double().mean())
    log(f"K9 raster_stochastic {tuple(got.shape)}, {chunks.shape[0]} chunks, "
        f"k={kk}, alpha={alpha}: slots with a depth {hit:.4f}")
    log(f"K9 walk: {chunk_visits(lists, counts, chunks.shape[0])}")
    check(0.0 < hit < 1.0, f"K9: share of filled slots {hit}")
    for a in (alpha, 1.0):
        run = (chunks, lists, counts, nby, nbx, first, rmin, rmax, kk, a)
        g = RC.raster_stochastic_blocks(*run)
        w = RC.raster_stochastic_blocks_plain(*run)
        mism = int((g != w).sum())
        log(f"K9 at alpha {a}: {mism} slot mismatches of {g.numel()} "
            "(bound: bit-exact)")
        check(torch.equal(g, w), f"K9 is not bit-exact at alpha {a}")
    short = lists[:, :2].contiguous()
    g = RC.raster_stochastic_blocks(chunks, short, counts, nby, nbx, first,
                                    rmin, rmax, kk, alpha)
    check(torch.equal(g, got), "K9 streaming every chunk disagrees with "
                               "its walk of the lists")
    pairs = float(walk_visits(lists, counts, chunks.shape[0]).sum()) \
        * RC.TC * 256
    # no PyTorch call rasterizes triangles: no library yardstick
    return with_bound(
        dict(max_abs_err=0.0, mismatches=0, exact=True,
             ms=cuda_ms(lambda: RC.raster_stochastic_blocks(*args, **kwargs),
                        10, 2),
             plain_ms=cuda_ms(lambda: RC.raster_stochastic_blocks_plain(
                 *args, **kwargs), 1, 0),
             pairs=pairs, filled_share=hit),
        nbytes(chunks, lists, counts, first, rmin, rmax, got),
        pairs * RASTER_SD_FLOPS_PER_PAIR)


def dual_depth_frame(m, kernels):
    """One config-1 frame with HBAO's depthMode set to DualDepth after the
    graph was built: K6 runs once on two plane sets. Returns K6's call."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    k6 = kernels_by_name(kernels)["fetch_taps_same_class"]
    m.active_graph.get_pass("HBAO").cfg.update(depthMode="DualDepth")
    with record_main_path(kernels) as plain_calls:
        for k in kernels:
            k.calls.clear()
        torch.cuda.synchronize()
        LAUNCHES.clear()
        out = m.renderFrame()
        check(not plain_calls, f"plain versions ran: {plain_calls}")
    m.active_graph.get_pass("HBAO").cfg.update(depthMode="SingleDepth")
    check_config_outputs("config1", out)
    check(k6.launches == 1 and len(k6.calls) == 1
          and k6.calls[0][0][0].shape[0] == 2,
          "DualDepth: K6 did not run once on two plane sets")
    log("config1 DualDepth frame: K6 launched once on 2 plane sets")
    return k6.calls[0]


def small_configs_against_references():
    """The configs' graphs and SVAO.py at their golden settings on the
    card, held against the committed goldens (tests/image_refs; the JAX
    package's output) by the golden runner's MSE bound, 2e-4
    (rtsdm_tpu/testing/image_tests.py:96-100). SVAO.py's golden traces its
    SD map with K7 (CornellBox: one chunk), every frame."""
    import numpy as np
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    res = {}
    for test, script in (("test_HBAO", HBAO_SCRIPT),
                         ("test_SVAO_rasterSD", GRAPH_SCRIPT),
                         ("test_SVAO_full", SVAO_FULL_SCRIPT)):
        ns = {}
        exec((ROOT / "tests" / "image_tests" / "renderpasses"
              / f"{test}.py").read_text(), ns)
        cfg = ns["IMAGE_TEST"]
        m = Renderer(cfg["width"], cfg["height"], device="cuda")
        run_script(str(script), m)
        if "guard_band" in cfg:
            m.active_graph.get_pass("GuardBand").cfg["guardBand"] = \
                cfg["guard_band"]
        for name, props in cfg.get("pass_overrides", {}).items():
            m.active_graph.get_pass(name).cfg.update(props)
        m.loadScene(cfg["scene"])
        m.clock.pause()
        LAUNCHES.clear()
        for f in range(max(cfg["frames"]) + 1):
            m.clock.frame = f
            out = m.renderFrame()
        if test == "test_SVAO_full":
            n = LAUNCHES["rtsdm_sd_trace_resident"]
            check(n == max(cfg["frames"]) + 1
                  and LAUNCHES["rtsdm_sd_trace"] == 0,
                  f"{test}: K7 launched {n} times, K5 "
                  f"{LAUNCHES['rtsdm_sd_trace']}")
        for name in ns["OUTPUTS"]:
            ref = np.load(ROOT / "tests" / "image_refs"
                          / f"{test}.{name}.{max(cfg['frames'])}.npy")
            img = out[name].float().cpu().numpy()
            check(img.shape == ref.shape, f"{test} {name}: shape")
            mse = float(((img - ref.astype(np.float32)) ** 2).mean())
            res[f"{test}.{name}"] = mse
            log(f"{test} {name} on the card vs the committed golden: MSE "
                f"{mse:.4g} (bound 2e-4)")
            check(mse <= 2e-4, f"{test} {name}: MSE {mse} above 2e-4")
    return res


def run_configs():
    """Phases 11-14: configs 2 and 1 through the harness, their kernels
    against their plain versions, their frame times; then the golden
    settings on the card. Returns (kernel rows, per-config report)."""
    report = {}
    rows = []
    k6_calls = []
    for label in ("config2", "config1", "config1_suntemple"):
        kernels = kernels_of_configs()
        by_name = kernels_by_name(kernels)
        m, totals, modes = drive_config(label, kernels)
        held = check_config_calls(label, kernels)
        if label == "config2":
            rows.append(dict(compare_raster_stochastic(
                by_name["raster_stochastic"]),
                name="raster_stochastic",
                launches=totals["raster_stochastic"]))
        else:
            k6_calls += by_name["fetch_taps_same_class"].calls
        if label == "config1":
            k6_calls.append(dual_depth_frame(m, kernels))
        if label == "config1_suntemple":
            rows.append(dict(compare_raster_floor(by_name["raster"].calls),
                             name=FLOOR, launches=totals[FLOOR]))
            rows.append(dict(compare_taps_same_class(k6_calls, label),
                             name="fetch_taps_same_class",
                             launches=totals["fetch_taps_same_class"]))
        times, _ = graph_timing(m)
        script, scene, width, height, overrides, _ = CONFIGS[label]
        report[label] = dict(times, script=str(script.relative_to(ROOT)),
                             scene=scene, width=width, height=height,
                             overrides=overrides, launches=totals,
                             warp_launches_by_mode=modes,
                             frames=CONFIG_FRAMES, bit_exact_calls=held)
        del m
    report["goldens_mse"] = small_configs_against_references()
    src = kernels_by_name(kernels_of_configs())
    for r in rows:
        k = src[r["name"].split(":")[0]]
        r.update(source=k.source, replaces=k.replaces,
                 config_launches={lb: report[lb]["launches"].get(r["name"], 0)
                                  for lb in CONFIGS if lb in report})
    return rows, report

# ---------------------------------------------------------------------------
# scripts/SVAO.py, the reference's shipped SVAO graph, with the resident SD
# tier (K7) and the SD trace's MaxCount and coverage insertion
# ---------------------------------------------------------------------------

# StochasticDepthMapRT settings held on both tiers at the Arcade rays
SD_SETTINGS = {"default": {"Implementation": "default"},
               "kbuffer": {"Implementation": "kbuffer"},
               "coverage": {"Implementation": "coverage", "Alpha": 0.375},
               "maxcount8": {"Implementation": "default", "MaxCount": 8}}


@contextlib.contextmanager
def sd_trace_calls():
    """Record (wrapper name, args, kwargs, output) of every K5 and K7 call."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    names = ("sd_trace_blocks", "sd_trace_resident_blocks")
    real = {n: getattr(RT, n) for n in names}
    calls = []

    def rec(name):
        def f(*args, **kwargs):
            out = real[name](*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return f

    for n in names:
        setattr(RT, n, rec(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(RT, n, fn)


def hold_sd_call(call, what: str):
    """A K5 or K7 call against its plain version: bit-exact."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    name, args, kwargs, out = call
    plain = getattr(RT, name + "_plain")(*args, **kwargs)
    mism = int((out != plain).any(1).sum())
    check(torch.equal(out, plain), f"{what}: {name} is not bit-exact "
                                   f"({mism} rays differ)")
    return mism


def resident_visits(args):
    """Chunks each K7 block visits: its world-box overlaps (the plain
    version's lists), as float64."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    tri, aabb, origin, rays = args[:4]
    _, counts = RT.build_chunk_lists(aabb, origin, rays[0:3].T, rays[3],
                                     rays[4])
    return counts.double()


def sd_tiers_at(scene, sd_ctx, sd_inputs, base):
    """StochasticDepthMapRT at the Arcade frame's SD inputs in each of
    SD_SETTINGS on both tiers (pallasStream False: K7, True: K5): each call
    bit-exact against its plain version, and the two tiers' packed slots
    equal bit for bit (K7's row-major rays against K5's 8x32 tiles).
    Returns {setting: {tier: (wrapper name, args, kwargs, out)}}."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    from rtsdm_tpu_torch.passes.stochastic_depth import StochasticDepthMapRT
    sd_h, sd_w = sd_inputs["rayMax"].shape
    ph = sd_h + (-sd_h) % RT.TILE_RH
    pw = sd_w + (-sd_w) % RT.TILE_RW
    res = {}
    for setting, props in SD_SETTINGS.items():
        res[setting] = {}
        depths = {}
        for stream in (False, True):
            p = StochasticDepthMapRT({**base, **props,
                                      "pallasStream": stream})
            p.set_scene(scene)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            with sd_trace_calls() as calls:
                out, _ = p.execute(sd_ctx, sd_inputs)
            torch.cuda.synchronize()
            k7, k5 = (LAUNCHES["rtsdm_sd_trace_resident"],
                      LAUNCHES["rtsdm_sd_trace"])
            check((k5, k7) == ((1, 0) if stream else (0, 1)) and
                  len(calls) == 1, f"SD {setting} pallasStream={stream}: "
                                   f"K7 {k7}, K5 {k5} launches")
            hold_sd_call(calls[0], f"SD {setting}")
            res[setting]["stream" if stream else "resident"] = calls[0]
            depths[stream] = out["stochasticDepth"]
        k = depths[False].shape[-1]
        resident = res[setting]["resident"][3][:sd_h * sd_w] \
            .reshape(sd_h, sd_w, k)
        stream = RT.tile_unflatten(res[setting]["stream"][3][:ph * pw], ph,
                                   pw)[:sd_h, :sd_w]
        mism = int((resident != stream).any(-1).sum())
        filled = float((resident != RT.INVALID).any(-1).double().mean())
        log(f"SD {setting} at {sd_w}x{sd_h} rays: K7 and K5 each bit-exact "
            f"with their plain versions; K7 vs K5 {mism} rays differ "
            f"(bound: bit-exact); rays with a hit {filled:.4f}")
        check(mism == 0, f"SD {setting}: K7 and K5 disagree on {mism} rays")
        check(torch.equal(depths[False], depths[True]),
              f"SD {setting}: the two tiers' depths differ")
        check(filled > 0.0, f"SD {setting}: no hit")
    return res


def svao_full_sd_phases(m):
    """After SVAO.py's frames: one frame with SVAO's stochMaxCount 8 (K7
    with the cap, held), then the SD pass at the next frame's inputs in
    every SD_SETTINGS entry on both tiers (sd_tiers_at). Returns (tiers,
    filled slots per ray under the cap)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    from rtsdm_tpu_torch.passes.stochastic_depth import StochasticDepthMapRT
    svao = m.active_graph.get_pass("SVAO")
    svao.cfg["stochMaxCount"] = 8
    with sd_trace_calls() as calls:
        m.renderFrame()
    svao.cfg["stochMaxCount"] = 0
    check(len(calls) == 1 and calls[0][0] == "sd_trace_resident_blocks"
          and calls[0][1][7] == 8,
          "SVAO.py with stochMaxCount 8: not one K7 call with MaxCount 8")
    hold_sd_call(calls[0], "SVAO.py stochMaxCount 8")
    capped = float((calls[0][3] != RT.INVALID).sum(1).double().mean())
    log(f"svao_full stochMaxCount 8: K7 bit-exact with its plain version; "
        f"{capped:.4f} filled slots per ray")

    # the nested SD graph is rebuilt with the restored properties, so the
    # capture goes on the class
    seen = []
    real_exec = StochasticDepthMapRT.execute

    def capture(self, ctx, inputs, state=None):
        seen.append((self.cfg, ctx, dict(inputs)))
        return real_exec(self, ctx, inputs, state)

    StochasticDepthMapRT.execute = capture
    try:
        m.renderFrame()
    finally:
        StochasticDepthMapRT.execute = real_exec
    check(len(seen) == 1, "the SD pass did not run once")
    cfg, sd_ctx, sd_inputs = seen[0]
    base = {k: v for k, v in cfg.items()
            if k not in ("Implementation", "MaxCount", "pallasStream")}
    return sd_tiers_at(m._scene_comp, sd_ctx, sd_inputs, base), capped


def resident_row(tiers):
    """K7's kernel row from the default setting's call: bit-exact error,
    kernel and plain times, its bound; and K5's time on the same rays."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    _, args, kwargs, out = tiers["default"]["resident"]
    plain = RT.sd_trace_resident_blocks_plain(*args, **kwargs)
    err = _max_abs(RT.decode_packed(out, 0.0, 1.0),
                   RT.decode_packed(plain, 0.0, 1.0))
    visits = resident_visits(args)
    n_chunks = args[0].shape[0]
    log(f"K7 sd_trace_resident {out.shape[0]} rays x {out.shape[1]} slots, "
        f"{n_chunks} chunks: {visits.numel()} blocks visit "
        f"{float(visits.mean()):.1f} chunks on average (max "
        f"{int(visits.max())}, {int(visits.sum())} in all)")
    ms = cuda_ms(lambda: RT.sd_trace_resident_blocks(*args, **kwargs), 10, 2)
    plain_ms = cuda_ms(lambda: RT.sd_trace_resident_blocks_plain(
        *args, **kwargs), 1, 1)
    _, a5, kw5, _ = tiers["default"]["stream"]
    ms5 = cuda_ms(lambda: RT.sd_trace_blocks(*a5, **kw5), 10, 2)
    v5 = walk_visits(a5[1], a5[2], a5[0].shape[0])
    log(f"K7 {ms:.4f} ms (plain {plain_ms:.2f} ms); K5 on the same rays in "
        f"8x32 tiles with its lists {ms5:.4f} ms "
        f"({chunk_visits(a5[1], a5[2], a5[0].shape[0])})")
    return with_bound(
        dict(max_abs_err=err, mismatches=0, exact=True, ms=ms,
             plain_ms=plain_ms, timed_at=f"{tuple(out.shape)} rays x slots, "
             f"{n_chunks} chunks", chunk_visits=int(visits.sum()),
             k5_same_rays_ms=ms5, k5_chunk_visits=int(v5.sum())),
        nbytes(args[:4], out),
        float(visits.sum()) * RT.TC * RT.RB * TRACE_FLOPS_PER_TEST)


def run_svao_full():
    """scripts/SVAO.py at Arcade@full 1280x720 through Renderer.renderFrame
    (the script's own properties): CONFIG_FRAMES frames with K7 once and
    K5 never per frame, the last frame's calls bit-exact against their
    plain versions (K1-K4, K7, K8, K10); svao_full_sd_phases; K7's row; the
    frame timed as in 10. Returns (K7's kernel row, report)."""
    label = "svao_full"
    kernels = kernels_of_configs()
    by_name = kernels_by_name(kernels)
    m, totals, modes = drive_config(label, kernels)
    held = check_config_calls(label, kernels)
    tiers, capped = svao_full_sd_phases(m)
    row = resident_row(tiers)
    times, _ = graph_timing(m)
    row = dict(row, name="sd_trace_resident",
               launches=totals["sd_trace_resident"],
               device_ms_profiled_frame=times["kernel_device_ms"].get(
                   "sd_trace_resident"),
               source=by_name["sd_trace_resident"].source,
               replaces=by_name["sd_trace_resident"].replaces)
    script, scene, width, height, overrides, _ = CONFIGS[label]
    report = dict(times, script=str(script.relative_to(ROOT)), scene=scene,
                  width=width, height=height, launches=totals,
                  warp_launches_by_mode=modes, frames=CONFIG_FRAMES,
                  bit_exact_calls=held, maxcount8_filled_slots=capped,
                  sd_tiers_bit_exact=sorted(tiers))
    del m
    return row, report


def maxcount_on_main_path(scene):
    """One SVAO-path frame at SunTemple@full with stochMaxCount 8: K5 (the
    streamed tier, 323,202 triangles) held bit-exact against its plain
    version with the cap, and timed beside the uncapped trace."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    pass_, ctx = make_svao(scene, WIDTH, HEIGHT,
                           {**SVAO_PROPS, "stochMaxCount": 8})
    with sd_trace_calls() as calls:
        frame(scene, pass_, ctx, WIDTH, HEIGHT)
        torch.cuda.synchronize()
    check(len(calls) == 1 and calls[0][0] == "sd_trace_blocks",
          "SVAO path with stochMaxCount 8: not one K5 call")
    hold_sd_call(calls[0], "SVAO path stochMaxCount 8")
    _, args, kwargs, out = calls[0]
    check(args[7] == 8, f"K5 took max_count {args[7]}")
    ms = cuda_ms(lambda: RT.sd_trace_blocks(*args, **kwargs), 10, 2)
    free = args[:7] + (0,) + args[8:]     # the same call uncapped
    ms_free = cuda_ms(lambda: RT.sd_trace_blocks(*free, **kwargs), 10, 2)
    filled = float((out != RT.INVALID).sum(1).double().mean())
    log(f"SVAO path stochMaxCount 8: K5 bit-exact with its plain version; "
        f"{filled:.4f} filled slots per ray; K5 {ms:.4f} ms with the cap, "
        f"{ms_free:.4f} ms without")
    return dict(k5_ms_maxcount8=ms, k5_ms_uncapped=ms_free,
                filled_slots_per_ray=filled)

# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    load_port()
    from rtsdm_tpu_torch import _build
    from rtsdm_tpu_torch.scene.procedural import sun_temple

    ident = gpu_identity()
    kind = torch.cuda.get_device_name(0)
    log(ident)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    _build.kernel_library()
    _build.scenekit_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS['kernels']:.2f} s, g++ "
        f"{_build.BUILD_SECONDS['scenekit']:.2f} s)")

    t0 = time.perf_counter()
    scene = sun_temple(aspect=WIDTH / HEIGHT, detail="full", device="cuda")
    log(f"scene: SunTemple@full, {scene.num_triangles} triangles, "
        f"{time.perf_counter() - t0:.2f} s")

    kernels = kernels_of_path()
    pass_, ctx, counts = drive_main_path(scene, kernels)

    for k in kernels:
        k.result = COMPARE[k.name](k)
        log(f"  {k.name}: kernel {k.result['ms']:.4f} ms, plain "
            f"{k.result['plain_ms']:.4f} ms")
    maxcount = maxcount_on_main_path(scene)

    torch.cuda.reset_peak_memory_stats()
    stages = staged_frame_ms(scene, pass_, ctx)
    host_ms = frame_host_ms(scene, pass_, ctx)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("steady-state frame, device time per stage (CUDA events, mean of 5): "
        + ", ".join(f"{n} {v:.3f} ms" for n, v in stages.items()))
    log(f"steady-state frame, host clock through SVAO.execute (mean of 5): "
        f"{host_ms:.3f} ms; peak device memory {peak_gib:.2f} GiB")
    check(all(math.isfinite(v) and v > 0 for v in stages.values()),
          "stage times")
    acts = profiled_frame(scene, pass_, ctx)
    busy_ms = sum(ms for ms, _ in acts.values())
    if acts:
        top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:12]
        log(f"profiled frame: {sum(n for _, n in acts.values())} device "
            f"activities, {busy_ms:.3f} ms busy; device idle share of the "
            f"unprofiled host-clock frame {1.0 - busy_ms / host_ms:.4f}")
        for name, (ms, n) in top:
            log(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")
        dev_ms = {k.name: kernel_device_ms(acts, k.name) for k in kernels}
        log("kernels' device time in the profiled frame: " + ", ".join(
            f"{n} " + ("not measured" if v is None else f"{v:.4f} ms")
            for n, v in dev_ms.items()))
    else:
        log("profiled frame: the profiler saw no device activity; device "
            "busy time not measured")

    small_frame_against_cpu()

    # the graph path (phases 8-10)
    graph_kernels = kernels_of_graph()
    m, graph_counts, warp_modes = drive_graph(graph_kernels, counts)
    by_name = kernels_by_name(graph_kernels)
    rows = [dict(k.result, name=k.name, launches=counts[k.name],
                 source=k.source, replaces=k.replaces) for k in kernels]
    rows += [dict(r, launches=graph_counts["any_hit"],
                  source=by_name["any_hit"].source,
                  replaces=by_name["any_hit"].replaces)
             for r in compare_any_hit(by_name["any_hit"])]
    rows += [dict(r, source=by_name["warp_resample"].source,
                  replaces=by_name["warp_resample"].replaces)
             for r in compare_warp(by_name["warp_resample"], warp_modes)]
    for r in rows:
        base = r["name"].split(":")[0]
        r["graph_launches"] = (warp_modes.get(r["name"].split(":")[1], 0)
                               if ":" in r["name"]
                               else graph_counts.get(base, 0))
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library "
            + ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms"))
    graph_times, _ = graph_timing(m)
    del m

    # BASELINE configs 1 and 2 (phases 11-14)
    config_rows, configs = run_configs()
    k7_row, svao_full = run_svao_full()
    config_rows.append(k7_row)
    rows += config_rows
    for r in config_rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library none; launches {r['launches']}")

    print(json.dumps({"frame": {
        "gpu": ident, "stages_ms": stages, "host_ms": host_ms,
        "device_busy_ms": busy_ms if acts else None,
        "kernel_device_ms": {k.name: kernel_device_ms(acts, k.name)
                             for k in kernels},
        "peak_device_gib": peak_gib,
        "graph": dict(graph_times, script=str(GRAPH_SCRIPT.relative_to(ROOT)),
                      scene=GRAPH_SCENE, launches=graph_counts,
                      warp_launches_by_mode=warp_modes),
        "configs": configs, "svao_full": svao_full,
        "svao_path_maxcount8": maxcount}}))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {**{k: dict(r, route="cuda")[k] for k in keys},
         **{k: v for k, v in r.items() if k not in keys
            and k not in ("exact", "mismatches")}} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
