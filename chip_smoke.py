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
   the card, with the tolerance stated (K1, which culls each chunk's
   triangles per half tile, against the plain version without the cull),
   and time both (CUDA events; the kernel also by torch.profiler and its
   host enqueue); K1's walk and cull replayed on the host give its bounds
   on the pairs it evaluates and on every lane of every visit; the host
   time of K1's inputs and cull boxes; K3's and K4's wrappers' host time
   piece by piece (fetch_host_split); K4's wrapper runs its kernel and
   nothing else on the card (torch.profiler: the pack is in the kernel);
   the G-buffer's attribute fetch piece by piece (gbuffer_host_split: face
   normals, the table, K2's wrapper, by host clock and device time); K5's
   and K7's resources (registers,
   shared memory, blocks an SM) and the SD trace stage piece by piece
   (sd_stage_split: each rt_cuda function the SD pass calls, by CUDA events
   and host time; K5's row is its whole wrapper, lists included);
6. time a steady-state frame by the program's own spans (host clock:
   renderFrame, the SVAO pass and its phase1, sd_map and phase2), and
   profile one frame (torch.profiler: device time by kernel, and the
   device's idle share of the frame);
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
   last frame (K8 on a spread subset of whole 8x32 tiles: its hits against
   the plain version without its per-ray cull, its pairs against the
   cull's replay; over every tile, its hits against K8 with boxes that cull
   nothing), K8's cull replayed over the walk (k8_walk: its yield, the
   boxes warps stage, the operations its bound counts) and timed without
   the cull and on the per-pair path; K10 also on a
   synthetic motion field at the TAA shape; time the kernels, their plain
   versions and K10's library yardstick (grid_sample), K10 in each mode by
   CUDA events, torch.profiler and its host enqueue at TAA's shape with 3
   channels and 1, grid_sample beside it measured the same ways; time every
   K1 call of the graph's last frame with its walk and cull;
10. time the graph frame: host-clock median over 7 frames after a warm-up,
   per-pass CUDA events, and one profiled frame (device busy, idle share);
11. BASELINE config 2 (bench_configs.py:20-23): scripts/SVAO_small.py with
   SVAO's stochasticDepthImpl set to 'Raster' after the graph was built,
   Arcade@full 1280x720, 3 frames. Per frame K9 (raster_stochastic)
   launches once and K5 never; K1-K4 and K8 as the graph gives them. Every
   call of the last frame of K1-K4, K8 and K10 is held bit-exact against its
   plain version at the config's shapes (K4 with no SD guard band; K8 on a
   spread subset of tiles), and so is K9 (with its per-triangle cull,
   against the plain version without it), at the path's alpha and at 1.0,
   its walk whole and split, and on short lists that stream every chunk;
   K9's walk, cull and visits per tile replayed on the host; K9 timed with
   its walk in 1, 4, 8, 16 and 32 parts and its default in turns (CUDA
   events and torch.profiler); every K1 call timed as in 9; then the frame
   is timed as in 10;
12. BASELINE config 1: scripts/HBAO.py on CornellBox 256x256, 3 frames. Per
   frame K6 (fetch_taps_same_class) launches once and K1 once with its
   depth floor (DepthPeeling) besides its two plain launches; the last
   frame's calls held as in 11; then one frame with HBAO's depthMode set to
   DualDepth (K6 on two plane sets); timed as in 10;
13. config 1's graph again on SunTemple@full 1920x1080, where K6 and the
   floored K1 do real work: the last frame's calls held as in 11, K6 held
   bit-exact on every call kept (also the CornellBox and DualDepth calls),
   K6 (CUDA events, torch.profiler per call) and the floored K1 timed; the
   frame timed as in 10;
14. both configs' graphs, scripts/SVAO.py, scripts/Forward.py (three
   goldens, K8 once a frame) and SVAO_small.py with a guard band at their
   golden settings on the card (tests/image_tests/renderpasses/
   test_HBAO.py, test_SVAO_rasterSD.py, test_SVAO_full.py, test_Forward.py,
   test_Forward_arcade.py, test_SVAO_guardband.py, renderscripts/
   test_TAA_sweep.py; SVAO.py traces with K7), held against the committed
   goldens by the golden runner's MSE bound;
15. scripts/SVAO.py (the reference's shipped SVAO graph) at Arcade@full
   1280x720 through Renderer.renderFrame, 3 frames: per frame K7
   (sd_trace_resident: 38,610 triangles, at most 65,536) launches once and
   K5 never; the last frame's calls of K1-K4, K7, K8 and K10 held
   bit-exact against their plain versions; one frame with SVAO's
   stochMaxCount 8 (K7 with the cap, held); StochasticDepthMapRT at that
   frame's SD inputs in the default, kbuffer, coverage (alpha 0.375) and
   MaxCount 8 settings on both tiers, each call held and K7 equal to K5
   bit for bit; K7 and K5 timed on the same rays, K7's visits on its 8x32
   tiles and on 256 consecutive rays; the SD stage split; the frame timed
   as in 10. (Phase 5 also runs the SVAO path once with stochMaxCount 8:
   K5 with the cap, held and timed.)
16. with --parent DIR: the parent's SD stage (SVAO path and SVAO.py), K2
   (the SVAO path's and the graph's 2048x1208 call) and K4 (the SVAO
   path's call) against this checkout's, in turns in processes of their
   own (CUDA events around the wrapper, torch.profiler per call, host
   enqueue); both checkouts' K5 and K7 resources; phases 17, 17b and 17c
   through the parent's kernels, measured only;
17. scripts/SVAO_small.py at Arcade@full 480x270, frame 0, through K7 and
   through K5, each marked output held by MSE against the JAX package's
   render committed in tests/torch_refs/ (made by make_refs.py there);
17b. the same for scripts/HBAO.py (K6; HBAO's samplingMode "Shift", as the
   card takes it) and config 2 (K9) at the same scene, size and frame;
17c. the same for scripts/SVAO.py (K7 once a frame; K1 twice, never with
   its floor: the graph prunes DepthPass and DepthPeeling; K2-K4, K8, K10).
17d. the same for scripts/SVAO_quarter.py (BASELINE config 4's graph: K7
   once a frame, AOGuidedBlur's bright/dark fusion) and scripts/SVAO.py
   with SVAO's primaryDepthMode DualDepth (DepthPeeling's floored K1 once a
   frame), at the same scene, size and frame; this checkout only;
18. BASELINE config 4 (bench_configs.py:28-30): scripts/SVAO_quarter.py at
   Bistro@full (681,562 triangles) 1920x1080, 3 frames: SVAO at quarter
   res with dualAO, divisor 4. Per frame K5 launches once and K7 never, K3
   twice, K4 once, K1 and K2 twice, K8 once a light, one TAA (K10
   Catmull-Rom); no plain version runs; the outputs are 1080x1920 and
   finite, AO in [0, 1]. The last frame's calls held as in 11, K5's on a
   spread subset of whole tiles; K5 timed with its bound, and K8 with the
   bound of its pairs (k8_bound_at); the frame timed as in 10;
19. BASELINE config 3 (bench_configs.py:24-27): SVAO_small.py with
   stochMapDivisor 1 and stochMapGuardBand 512, SunTemple@full 1920x1080,
   3 frames: K5 once a frame on the full-resolution SD grid, K4 never
   (phase 2 reads the SD map through the plain fetch_sd_direction, XLA
   code in the JAX package too); held and timed as in 18;
20. scripts/SVAO.py at Arcade@full 1280x720: one frame with SVAO's
   primaryDepthMode DualDepth (DepthPeeling runs: K1 once with its floor,
   phase 1's K3 on two plane sets; the frame's calls held bit-exact) and
   one with secondaryDepthMode SingleDepth (no SD trace, no K4);
21. scripts/SVAO_depth.py at Arcade@full 1280x720, 3 frames on a paused
   clock: SVAO under DualDepth over TemporalDepthPeel's layer (phase 1
   alone: K3 on two plane sets) and SVAO_ref under the Raytraced secondary
   mode at full resolution (K3, then the brute-force interval query of
   ops/rt.py, plain PyTorch). Per frame K1 once plain and once floored
   (DepthPeeling), K2 once, K3 twice, no SD trace, no K4, no shadows,
   TemporalDepthPeel's K10 bilinear from frame 1; the last frame's calls
   held bit-exact; both outputs finite, AO in [0, 1]; the RT query timed by
   CUDA events with its rays and its ray-triangle tests; the frame timed as
   in 10 (3 host-clock frames);
22. scripts/SVAO.py at Arcade@full 1280x720, one frame each with
   samplingMode gather (no K3 or K4), kernel HBAO (K3 and K4 on HBAO's
   ring tables) and secondaryDepthMode Raytraced (the RT query timed), set
   after the build, each frame's calls held bit-exact; then one RTAO frame
   at that size (closest_hit, timed);
17e. scripts/SVAO_depth.py at Arcade@full 480x270, frame 1, against the JAX
   package's render (tests/torch_refs/SVAO_depth.*); then every mid-size
   graph (SVAO_small.py through K7 and K5, config 2, HBAO.py, SVAO.py and
   SVAO.py under DualDepth, SVAO_quarter.py, SVAO_depth.py) with the JAX
   package's raster channels substituted for the port's (<ref>.rasters.npz:
   the G-buffer's and DepthPeeling's that its AO reads), its AO outputs
   held under a bound far below the rasters' last bits; this checkout
   only;
23. one row of the quality oracle (rtsdm_tpu_torch/tools/quality_ssim.py):
   BASELINE config 2 at 640x360, SSIM of the ray-traced and the raster SD
   AO against SVAO's Raytraced mode and their mean absolute difference,
   reported, not gated;
24. BASELINE config 5 (bench_configs.py:31-33, animated as :51-66):
   scripts/SVAO_small.py on EmeraldSquare@full (1,036,922 triangles) at
   1280x720, the camera orbiting and the tallest 2% of the triangles
   oscillating, the clock playing, 3 frames: per frame K1 and K2 twice (K2
   interpolating last frame's positions too: (nci, nflat) = (11, 4)), K3
   twice, K4 once, K5 once, K8 once a light, K10 at least 6 times, no
   plain version; the outputs finite, AO in [0, 1], the motion vectors
   showing the camera's motion and the node's own; the last frame's calls
   held bit-exact (K5 and K8 on spread tile subsets), each kernel timed
   with its bound (K2 beside its (8, 4) template), the frame timed as in
   10, the animation step timed, peak device memory, and the quality
   oracle's config-5 row (ShadedTAA's temporal stability);
24b. the same animation on EmeraldSquare's small tier (K7) at 480x270,
   frames 0-2, against the JAX package's render
   (tests/torch_refs/SVAO_anim.*), with the port's own rasters and with
   the JAX package's per-frame G-buffer channels substituted;
24c. the golden test_MultiSampling (samples/MultiSampling.py: the Halton
   sample pattern, CornellBox 96x96, frame 2) within the golden runner's
   bound, every jittered K1 call held bit-exact.

The last three lines are JSON: the frames' times, one entry per kernel
({"kernels": [...]}, with its bound, library yardstick and launches per
frame in configs 3, 4 and 5), and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import functools
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


def device_ms(fn, symbol: str, reps: int):
    """Mean device time per launch of kernel `symbol` (a substring of the
    profiler's kernel name), which fn() launches once, over the launches
    the profiler recorded in `reps` calls of fn() under torch.profiler,
    after one warm-up call (it has dropped some records of a call's
    launches: the mean over `reps` then understated the time); None where
    it saw no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e.device_time_total for e in prof.events()
            if e.device_type == DeviceType.CUDA and symbol in e.name]
    if hits and len(hits) != reps:
        log(f"torch.profiler recorded {len(hits)} launches of {symbol} in "
            f"{reps} calls")
    return sum(hits) / 1e3 / len(hits) if hits else None


def host_us(fn, reps: int) -> float:
    """Host time per call of fn() in microseconds, without waiting for the
    device (the enqueue: a wrapper's checks, allocations and launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def synced_ms(fn, reps: int) -> float:
    """Host-clock time per call of fn() that ends in a synchronize (mean of
    `reps` after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def timings(fn, symbol: str, reps: int) -> dict:
    """A call's CUDA-event time (host work included), its kernel's device
    time (profiler) and its host enqueue time, in one place."""
    return dict(event_ms=cuda_ms(fn, reps, 3),
                device_ms=device_ms(fn, symbol, reps),
                host_us=host_us(fn, reps))


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
ANY_HIT_FLOPS_PER_PAIR_HOISTED = 32   # the same without d x e2, det and
                                      # adet (a warp of one direction)


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


def raster_walk(chunks, tri_boxes, lists, counts, nbx: int) -> dict:
    """K1's (or K9's, which culls alike) work at a call: chunks visited
    per tile, the lanes that survive its per-triangle cull per visit of a
    warp (half a tile; replayed on the
    host with the kernel's boxes and comparisons, raster_cuda.
    cull_survivors), the pixel-triangle pairs it evaluates, and the
    operation counts of both bounds: the pairs it evaluates, and every lane
    of every visit (the count without the cull)."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    visits = walk_visits(lists, counts, chunks.shape[0])
    surv = RC.cull_survivors(tri_boxes, lists, counts, nbx)
    n_surv = float(surv.clamp(min=0).double().sum())
    n_vis = float(visits.sum())
    per_tile = surv.clamp(min=0).double().sum((1, 2))
    return dict(tiles=counts.numel(), visits_mean=float(visits.mean()),
                visits_max=int(visits.max()), visits=int(n_vis),
                overflow_tiles=int((counts > lists.shape[1]).sum()),
                list_width=lists.shape[1],
                survivors_per_visit_mean=n_surv / max(2.0 * n_vis, 1.0),
                survivors_per_visit_max=max(int(surv.max()), 0)
                if surv.numel() else 0,
                survivors_per_tile_mean=float(per_tile.mean()),
                survivors_per_tile_max=float(per_tile.max()),
                pairs=n_surv * (RC.RB // 2),
                flops=n_surv * (RC.RB // 2) * RASTER_FLOPS_PER_TEST,
                flops_all_lanes=n_vis * RC.TC * RC.RB
                * RASTER_FLOPS_PER_TEST)


def walk_line(w: dict) -> str:
    return (f"{w['tiles']} tiles visit {w['visits_mean']:.2f} chunks on "
            f"average (max {w['visits_max']}, {w['visits']} in all; "
            f"{w['overflow_tiles']} overflow their list of "
            f"{w['list_width']}); {w['survivors_per_visit_mean']:.2f} of 128 "
            f"lanes survive a warp's cull (half a tile) per visit (max "
            f"{w['survivors_per_visit_max']}); per tile "
            f"{w['survivors_per_tile_mean']:.1f} survivors on average (max "
            f"{w['survivors_per_tile_max']:.0f}); {w['pairs']:.6g} "
            f"pixel-triangle pairs evaluated")


def raster_timing(args, kwargs, what: str, reps: int = 10) -> dict:
    """K1 at one call (args and kwargs of raster_cuda.raster_blocks): its
    walk and cull (raster_walk), CUDA-event, device and host times, and
    both bounds: on the pairs it evaluates (`bound_ms`) and on every lane
    of every visit (`bound_ms_all_lanes`, the count without the
    cull)."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    chunks, boxes, lists, counts, nby, nbx = args
    walk = raster_walk(chunks, boxes, lists, counts, nbx)
    t = timings(lambda: RC.raster_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["raster"], reps)
    n_bytes = nbytes(chunks, boxes, lists, counts, kwargs.get("floor"))
    n_bytes += 16 * RC.RB * nby * nbx   # z, id, b1, b2 written, 4 B each
    b_new, by_new = bound(n_bytes, walk["flops"])
    b_old, _ = bound(n_bytes - nbytes(boxes), walk["flops_all_lanes"])
    dev = ("not measured" if t["device_ms"] is None
           else f"{t['device_ms']:.4f} ms")
    log(f"K1 {what} {nby * 8}x{nbx * 32}, {chunks.shape[0]} chunks: "
        f"{walk_line(walk)}")
    log(f"K1 {what}: CUDA events {t['event_ms']:.4f} ms, device {dev}, "
        f"host enqueue {t['host_us']:.1f} us; bound {b_new:.4f} ms "
        f"({by_new}) on the pairs evaluated, {b_old:.4f} ms on every lane "
        "of every visit")
    return dict(walk, **t, bound_ms=b_new, bound_by=by_new,
                bound_bytes=n_bytes, bound_flops=walk["flops"],
                bound_ms_all_lanes=b_old)


def compare_raster(k):
    """K1 against its plain version without the per-triangle cull (the
    contract the CPU tests hold against the JAX package): bit-exact
    expected (--fmad=false and PyTorch both round every operation; the
    cull drops only lanes that cannot cover a pixel of the tile); bounded
    residual: tri_id differs on at most 1e-4 of the pixels, and where the
    ids agree depth and barycentrics agree to 1e-6."""
    import torch
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    args, kwargs = k.calls[0]
    got = RC.raster_blocks(*args, **kwargs)
    want = RC.raster_blocks_plain(args[0], None, *args[2:], **kwargs)
    z, tid, b1, b2 = got
    same = tid == want[1]
    mism = int((~same).sum())
    err = max(_max_abs(x[same], y[same]) for x, y in
              ((z, want[0]), (b1, want[2]), (b2, want[3])))
    n = tid.numel()
    log(f"K1 raster {tuple(tid.shape)}, {args[0].shape[0]} chunks: tri_id "
        f"mismatches {mism} of {n}; max |diff| where ids agree {err:.3g} "
        f"(bounds: {int(1e-4 * n)} pixels, 1e-6)")
    check(mism <= 1e-4 * n and err <= 1e-6, "K1 disagrees with its plain "
                                            "version")
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    t = raster_timing(args, kwargs, "main path")
    # no PyTorch call rasterizes triangles: no library yardstick
    return dict(t, max_abs_err=err, mismatches=mism, exact=exact,
                ms=t["event_ms"], library_ms=None,
                plain_ms=cuda_ms(lambda: RC.raster_blocks_plain(
                    args[0], None, *args[2:], **kwargs), 1, 1))


def compare_fetch_attributes(k):
    """K2: bit-exact (same products and sums in the same order). Its bound
    reads the table rows of the triangles some pixel shows, once each (the
    rows this run's data needs; `bound_ms_whole_table`, the definition of
    PR 1-8, reads every row)."""
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
    t = timings(lambda: RC.fetch_attributes(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_attributes"], 50)
    log(f"K2 times: CUDA events {t['event_ms']:.4f} ms, device "
        f"{t['device_ms']} ms, host enqueue {t['host_us']:.1f} us")
    # b0 (2), then 3 products and 2 sums per interpolated component; no
    # single PyTorch call gathers and interpolates: no library yardstick
    flops = float((tri_id >= 0).sum()) * (2 + 5 * nci)
    table = args[2]
    rows = int(torch.unique(tri_id[tri_id >= 0]).numel())
    n_bytes = nbytes(args[:2], got) + rows * table.shape[1] * 4
    whole, _ = bound(nbytes(args[:3], got), flops)
    log(f"K2 bound: {rows} of {table.shape[0]} table rows read; "
        f"{bound(n_bytes, flops)[0]:.4f} ms ({whole:.4f} ms reading the "
        f"whole table)")
    return with_bound(
        dict(max_abs_err=err, mismatches=0, exact=True,
             ms=t["event_ms"], device_ms=t["device_ms"],
             host_us=t["host_us"], table_rows_read=rows,
             bound_ms_whole_table=whole,
             plain_ms=cuda_ms(lambda: RC.fetch_attributes_plain(
                 *args, **kwargs), 10, 2)),
        n_bytes, flops)


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
    t = timings(lambda: F.fetch_all_directions(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_all_directions"], 50)
    log(f"K3 times: CUDA events {t['event_ms']:.4f} ms, device "
        f"{t['device_ms']} ms, host enqueue {t['host_us']:.1f} us")
    # a copy per output after one product radius * radii[d]; no single
    # PyTorch call selects the level and shifts: no library yardstick
    return with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=True,
             ms=t["event_ms"], device_ms=t["device_ms"],
             host_us=t["host_us"], plain_ms=cuda_ms(plain, 5, 1)),
        nbytes(planes, radius, got), float(got.numel()))


K4_WRAPPER_REPS = 20   # calls whose device activity K4's check reads


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
    # the profiler drops some records of a launch (device_ms), so a single
    # call can show no activity at all: hold K4_WRAPPER_REPS calls, of which
    # every recorded activity must be K4's kernel, at most one a call
    acts = profiled(lambda: [F.fetch_sd_packed(*args, **kwargs)
                             for _ in range(K4_WRAPPER_REPS)])
    own = sum(c for n, (_, c) in acts.items()
              if KERNEL_SYMBOLS["fetch_sd_packed"] in n)
    others = {n: c for n, (_, c) in acts.items()
              if KERNEL_SYMBOLS["fetch_sd_packed"] not in n}
    log(f"K4's wrapper on the card (torch.profiler), {K4_WRAPPER_REPS} "
        f"calls: {own} launches of its kernel, other activities {others}")
    check(not others and 1 <= own <= K4_WRAPPER_REPS,
          "K4's wrapper runs more than its kernel on the card")
    t = timings(lambda: F.fetch_sd_packed(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_sd_packed"], 50)
    log(f"K4 times: CUDA events {t['event_ms']:.4f} ms, device "
        f"{t['device_ms']} ms, host enqueue {t['host_us']:.1f} us")
    # as K3, on the 16-bit packed SD map: no library yardstick
    return with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=True,
             ms=t["event_ms"], device_ms=t["device_ms"],
             host_us=t["host_us"], plain_ms=cuda_ms(plain, 5, 1)),
        nbytes(sd_map, radius, got), float(got.numel()))


def fetch_host_split(k3, k4) -> dict:
    """Host time of K3's and K4's wrappers, piece by piece (host clock, no
    synchronize; microseconds): the ring's tables (svao_shift._ring, twice
    a frame), the cached table lookup, the launch alone, and each wrapper
    whole (K3 also on two plane sets, with its stack's host and device
    time); K4's pack_sd16 apart. Beside them what the ring and the lookup
    cost where nothing is cached: offset_tables, the walk of its offsets
    into a tuple key, and the hash of that key."""
    import torch
    from rtsdm_tpu_torch._build import launch, ptr, stream_of
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.ops import ao_shift as S
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    from rtsdm_tpu_torch.passes import svao_shift
    args = k3.calls[0][0]
    sets, pad, radius, levels, offs, radii = args
    cfg = A.VAOConfig(radius=SVAO_PROPS["radius"], num_directions=8)
    lv, of, ra = S.offset_tables(cfg, cfg.ss_max_radius)
    key = (tuple(float(x) for x in lv), F.offs_tuple(of),
           tuple(float(r) for r in ra), (pad,))
    res = {"offset_tables_us": host_us(
               lambda: S.offset_tables(cfg, cfg.ss_max_radius), 20),
           "offsets_walk_us": host_us(lambda: F.offs_tuple(of), 50),
           "key_hash_us": host_us(lambda: hash(key), 50),
           "ring_us": host_us(lambda: svao_shift._ring(cfg), 50),
           "k3_lookup_us": host_us(lambda: F._tables(
               "dir", levels, offs, radii, (pad,), radius.device), 50)}
    planes = sets[0][None]
    bounds, radii_t, tab, _ = F._tables("dir", levels, offs, radii, (pad,),
                                        radius.device)
    qh, qw = radius.shape[1:]
    out = torch.empty((1, len(offs), 16, qh, qw), device=radius.device)
    res["k3_launch_us"] = host_us(lambda: launch(
        "rtsdm_fetch_directions", ptr(planes), ptr(radius), ptr(bounds),
        ptr(radii_t), ptr(tab), 1, len(offs), len(levels), qh, qw,
        planes.shape[2], planes.shape[3], ptr(out), stream_of(planes)), 50)
    res["k3_wrapper_us"] = host_us(lambda: F.fetch_all_directions(*args),
                                   50)
    # two plane sets (SVAO's and HBAO's DualDepth): the wrapper stacks
    # them, one copy of both padded layers a call
    two = [sets[0], sets[0]]
    res["k3_two_sets_wrapper_us"] = host_us(
        lambda: F.fetch_all_directions(two, *args[1:]), 50)
    res["k3_two_sets_stack_us"] = host_us(lambda: torch.stack(two), 50)
    res["k3_two_sets_stack_device_us"] = 1e3 * cuda_ms(
        lambda: torch.stack(two), 50)
    sd_map = k4.calls[0][0][0]
    res["k4_pack_us"] = host_us(lambda: F.pack_sd16(sd_map), 50)
    res["k4_wrapper_us"] = host_us(lambda: F.fetch_sd_packed(
        *k4.calls[0][0]), 50)
    log("K3/K4 host split (us, host clock): " + ", ".join(
        f"{n} {v:.1f}" for n, v in res.items()))
    return res


def gbuffer_host_split(scene, k2) -> dict:
    """The G-buffer's attribute fetch at K2's recorded call (the SVAO
    path's, SunTemple@full 1920x1080), piece by piece: host enqueue
    (host clock, no synchronize, us), CUDA-event time and device time
    (torch.profiler: every device activity of one call summed, and their
    count) of scene.face_normals(), pack_attr_rows of the five attributes,
    K2's wrapper, fetch_vertex_attributes building its table on every call
    (as the G-buffer called it before the table was kept), the kept
    table's lookup (passes/gbuffer.attribute_table) and
    fetch_vertex_attributes with it (the G-buffer's call now)."""
    from rtsdm_tpu_torch.ops import raster as R
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    from rtsdm_tpu_torch.passes.gbuffer import attribute_table
    args = k2.calls[0][0]
    tri_id, bary = args[:2]
    interp = [scene.positions, scene.normals, scene.texcoords]
    face_n = scene.face_normals()
    pieces = {
        "face_normals": scene.face_normals,
        "pack_attr_rows": lambda: RC.pack_attr_rows(
            interp, [face_n, scene.material_id]),
        "k2_wrapper": lambda: RC.fetch_attributes(*args),
        "fetch_vertex_attributes_table_each_call":
            lambda: R.fetch_vertex_attributes(
                tri_id, bary, interp,
                [scene.face_normals(), scene.material_id]),
        "attribute_table_kept": lambda: attribute_table(scene),
        "fetch_vertex_attributes_kept_table":
            lambda: R.fetch_vertex_attributes(
                tri_id, bary, table=attribute_table(scene)),
    }
    res = {}
    for name, fn in pieces.items():
        acts = profiled(fn)
        res[name] = dict(host_us=host_us(fn, 20), event_ms=cuda_ms(fn, 20, 3),
                         device_ms=sum(ms for ms, _ in acts.values()),
                         device_activities=sum(n for _, n in acts.values()))
        log(f"G-buffer split {name}: host enqueue "
            f"{res[name]['host_us']:.1f} us, CUDA events "
            f"{res[name]['event_ms']:.4f} ms, device "
            f"{res[name]['device_ms']:.4f} ms in "
            f"{res[name]['device_activities']} activities")
    return res


def k5_lists(args):
    """The lists K5 builds inside the kernel for a recorded sd_trace_blocks
    call (tri, aabb, origin, rays, k, cull_back, mode, max_count, alpha,
    rx, ry), as its plain version builds them: (lists, counts)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    aabb, origin, rays = args[1:4]
    rx, ry = (args[9], args[10]) if len(args) > 10 else (None, None)
    return RT.build_chunk_lists(aabb, origin, rays[0:3].T, rays[3], rays[4],
                                rx, ry)


def compare_sd_trace(k):
    """K5: bit-exact (--fmad=false; the reservoir keeps the k smallest
    distinct values whatever the insertion order): zero rays may differ.
    Also the key function on the INT_MIN hash, where |INT_MIN| stays
    negative (key 32765)."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    args, kwargs = k.calls[0]
    got = RT.sd_trace_blocks(*args, **kwargs)
    want = RT.sd_trace_blocks_plain(*args, **kwargs)
    mism = int((got != want).any(1).sum())
    err = _max_abs(RT.decode_packed(got, 0.0, 1.0),
                   RT.decode_packed(want, 0.0, 1.0))
    n = got.shape[0]
    n_chunks = args[0].shape[0]
    lists, counts = k5_lists(args)
    visits = walk_visits(lists, counts, n_chunks)
    log(f"K5 sd_trace {n} rays x {got.shape[1]} slots, {n_chunks} chunks: "
        f"{mism} rays differ; max |diff| of the decoded depths {err:.3g} "
        "(bound: bit-exact)")
    log(f"K5 walk: visits per block {spread(visits)}; rays with a hit "
        f"{float((got != RT.INVALID).any(1).double().mean()):.4f}")
    check(mism == 0 and torch.equal(got, want),
          f"K5 disagrees with its plain version on {mism} rays")
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
    tests = float(visits.sum()) * RT.TC * RT.RB
    # no PyTorch call traces rays: no library yardstick. `ms` is replaced
    # by the whole wrapper's time (sd_trace_stream, lists included) once
    # the stage split has run; kernel_ms keeps the launch alone.
    ms = cuda_ms(lambda: RT.sd_trace_blocks(*args, **kwargs), 10, 2)
    return with_bound(
        dict(max_abs_err=err, mismatches=mism,
             exact=bool(torch.equal(got, want)), ms=ms, kernel_ms=ms,
             plain_ms=cuda_ms(lambda: RT.sd_trace_blocks_plain(
                 *args, **kwargs), 1, 1),
             chunk_visits=int(visits.sum()), visits_per_block=spread(visits)),
        nbytes(args[:4], args[9:11], got), tests * TRACE_FLOPS_PER_TEST)


COMPARE = {"raster": compare_raster,
           "fetch_attributes": compare_fetch_attributes,
           "fetch_all_directions": compare_fetch_directions,
           "fetch_sd_packed": compare_fetch_sd_packed,
           "sd_trace": compare_sd_trace}


# ---------------------------------------------------------------------------
# steady-state stages
# ---------------------------------------------------------------------------

def frame_spans_ms(scene, pass_, ctx, reps: int = 5):
    """Host ms per steady-state frame (the mean over `reps` frames after
    one warm frame) of the program's own spans, as Renderer.renderFrame's
    profiler keeps them: renderFrame (the G-buffer, the SVAO pass and a
    synchronize), the pass (SVAO) and its phases (SVAO/phase1, SVAO/sd_map,
    SVAO/phase2), and every span inside; {scope path: ms}."""
    import torch
    from rtsdm_tpu_torch.core.profiler import Profiler
    prof = Profiler()
    ctx.profiler = prof
    try:
        for r in range(reps + 1):
            if r == 1:
                prof.reset()
            with prof.activate(), prof.event("renderFrame"):
                g, lin, packed = g_buffer_stage(scene, WIDTH, HEIGHT)
                with prof.event("SVAO"):
                    out, _ = pass_.execute(ctx, {"gbufferDepth": g["depth"],
                                                 "depth": lin,
                                                 "normals": packed})
                torch.cuda.synchronize()
            check(bool(torch.isfinite(out["ao"]).all()), "AO is not finite")
    finally:
        ctx.profiler = None
    return prof.flat_averages()


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


def spread_tiles(live, n: int, what: str):
    """Up to n tiles spread evenly over those of live [tiles, RB] (bool)
    that hold a live ray."""
    import torch
    live_tiles = torch.nonzero(live.any(1)).squeeze(1)
    check(live_tiles.numel() > 0, f"{what}: no live ray")
    pick = torch.linspace(0, live_tiles.numel() - 1,
                          min(n, live_tiles.numel()),
                          device=live.device).round().long().unique()
    return live_tiles[pick]


def any_hit_subset(tri, boxes, lists, counts, rays, tiles=ANY_HIT_TILES):
    """(sel, inputs): up to `tiles` whole 8x32 tiles spread evenly over the
    tiles that hold a live ray, and K8's inputs cut to them."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    nb = counts.shape[0]
    sel = spread_tiles((rays[7] > rays[6]).reshape(nb, RT.RB),
                       tiles, "K8")
    return sel, (tri, boxes, lists[sel].contiguous(),
                 counts[sel].contiguous(),
                 rays.reshape(8, nb, RT.RB)[:, sel].reshape(8, -1)
                 .contiguous())


def hold_any_hit(args, tiles=ANY_HIT_TILES):
    """K8 on the spread tile subset (any_hit_subset) against its plain
    version: hits against the walk without the cull (boxes None, the
    contract), pairs against the replay of K8's cull; and the launch over
    every tile cut to the subset against the launch on the subset. Returns
    (kernel outputs, plain outputs), each (hit, pairs, hit, pairs)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    tri, boxes, lists, counts, rays = args
    nb = counts.shape[0]
    full = RT.any_hit_blocks(*args)
    sel, sub = any_hit_subset(*args, tiles=tiles)
    got = RT.any_hit_blocks(*sub)
    hit_p, _ = RT.any_hit_blocks_plain(tri, None, *sub[2:])
    _, pairs_p = RT.any_hit_blocks_plain(*sub)
    return (got + tuple(a.reshape(nb, RT.RB)[sel].reshape(-1)
                        for a in full),
            (hit_p, pairs_p) + got)


def warp_directions(rays):
    """[nb, 8] bool: every live ray of the warp (a tile row of 32) has the
    direction of its first live ray, bit for bit (K8 hoists d x e2 and det
    there), and [nb] bool: all 256 rays of the tile share one direction."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    nb = rays.shape[1] // RT.RB
    d = rays[3:6].contiguous().view(torch.int32).reshape(3, nb, 8, 32)
    live = (rays[7] > rays[6]).reshape(nb, 8, 32)
    lead = torch.argmax(live.to(torch.int32), -1)            # [nb, 8]
    ld = torch.gather(d, 3, lead[None, ..., None].expand(3, nb, 8, 1))
    warp = ((d == ld).all(0) | ~live).all(-1)
    dt = d.reshape(3, nb, RT.RB)
    tile = (dt == dt[..., :1]).all(0).all(-1)
    return warp, tile


def k8_walk(tri, boxes, lists, counts, rays, pairs_free,
            budget: int = 1 << 16):
    """K8's cull replayed over the walk (its yield, and the work its bound
    counts): a live ray walks its tile's list up to the chunk of its first
    hit, ceil(pairs_free / 128) chunks (pairs_free from
    the walk without the cull; the cull keeps every hit, so the walk is the
    same). Counts the (live ray, walked chunk) pairs, those whose segment
    meets the chunk's box (the union of its four) and the (ray, chunk, box)
    triples that meet under K8's slab test; per warp (a tile row), the
    chunk visits and the boxes it stages (some lane meets), split by
    whether the warp hoists. Each step takes a block of list positions for
    every tile still walking, about `budget` (tile, position) pairs."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    nb, list_w = lists.shape
    full = counts > list_w
    live = (rays[7] > rays[6]).reshape(nb, RT.RB)
    walk = torch.div(pairs_free.reshape(nb, RT.RB) + RT.TC - 1, RT.TC,
                     rounding_mode="floor")
    walk = torch.where(live, walk, 0)
    longest = walk.max(1).values                    # per tile
    hoist, _ = warp_directions(rays)
    o, inv, flat, tmin, tmax = (a.reshape(a.shape[:-1] + (nb, RT.RB))
                                for a in RT.slab_rows(rays))
    union = torch.cat([boxes[:, 0:3].amin(-1), boxes[:, 3:6].amax(-1)], 1)
    tot = collections.Counter()
    j0, end = 0, int(longest.max()) if nb else 0
    while j0 < end:
        rows = torch.nonzero(longest > j0).squeeze(1)
        nj = max(1, min(end - j0, budget // rows.numel()))
        js = torch.arange(j0, j0 + nj, device=lists.device)
        ci = torch.where(full[rows, None], js[None],
                         lists[rows][:, js.clamp(max=list_w - 1)]).long()
        a = walk[rows][..., None] > js                  # [na, RB, nj]
        ray = [x[:, rows, :, None] for x in (o, inv, flat)]
        tn, tf = tmin[rows][..., None], tmax[rows][..., None]
        u = union[ci]                                   # [na, nj, 6]
        meet_c = RT.segment_overlaps(
            *ray, tn, tf, [u[:, None, :, c] for c in range(3)],
            [u[:, None, :, 3 + c] for c in range(3)]) & a
        bx = boxes[ci]                                  # [na, nj, 6, 4]
        meet = RT.segment_overlaps(
            *[x[..., None] for x in ray], tn[..., None], tf[..., None],
            [bx[:, None, :, c, :] for c in range(3)],
            [bx[:, None, :, 3 + c, :] for c in range(3)]) & a[..., None]
        na = rows.numel()
        warp_on = a.reshape(na, 8, 32, nj).any(2)       # [na, 8, nj]
        staged = meet.reshape(na, 8, 32, nj, RT.N_CULL).any(2).sum(-1)
        h = hoist[rows]
        tot["ray_chunks"] += int(a.sum())
        tot["chunk_meets"] += int(meet_c.sum())
        tot["box_meets"] += int(meet.sum())
        tot["warp_visits"] += int(warp_on.sum())
        tot["staged_hoisted"] += int(staged[h].sum())
        tot["staged_per_pair"] += int(staged[~h].sum())
        j0 += nj
    return dict(tot)


def any_hit_work(walk, pairs, rays):
    """fp32 operations of K8 on this run's data, counted from any_hit.cu:
    per pair tested 32 in a hoisting warp (o - v0 3, u*det 5, tv x e1 9,
    v*det 5, t*det 5, the sign products 3, the interval 2) and 47 in
    another (adding d x e2 9, det 5, adet 1); per box staged by a hoisting
    warp 32 x 16 (d x e2 9, det 5, adet 1, 1/det 1); per slab test 12
    (four boxes per live ray and chunk visit)."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    hoist, _ = warp_directions(rays)
    p = pairs.reshape(hoist.shape + (32,)).double().sum(-1)
    ops = (float(p[hoist].sum()) * ANY_HIT_FLOPS_PER_PAIR_HOISTED
           + float(p[~hoist].sum()) * ANY_HIT_FLOPS_PER_PAIR
           + walk.get("staged_hoisted", 0) * RT.CULL_SUB * 16
           + walk.get("ray_chunks", 0) * RT.N_CULL * 12)
    return ops, float(p[hoist].sum()), float(p[~hoist].sum())


def nudged_directions(rays):
    """The same rays with dx of every odd lane moved by one ulp: no warp
    with live rays of both parities hoists, so K8 forms d x e2 and det per
    pair (a timing variant; the hits may differ from the real rays')."""
    import torch
    r = rays.clone()
    dx = r[3, 1::2]
    r[3, 1::2] = torch.nextafter(dx, torch.full_like(dx, float("inf")))
    return r.contiguous()


def compare_any_hit(k):
    """K8 on the graph's last-frame call: hits bit-exact against the plain
    version without the cull and pairs against the replay of the cull, on
    ANY_HIT_TILES whole 8x32 tiles spread evenly over the tiles that hold
    a live ray (the plain version over all 2.47M rays would take too long);
    the launch over every tile gives the same answers on those tiles as its
    launch on the subset, and the same hits as K8 with boxes that cull
    nothing (whose pairs, the walk without the cull, are held against the
    plain version without the cull on the subset). The cull's yield over
    the walk (k8_walk) and the warps that hoist (warp_directions). Timing
    variants, each on the same tiles: boxes that cull nothing, one
    box per chunk (the union of its four), the per-pair path, and the
    per-pair path without the cull. Bounds: the pairs this run needed x
    the operations per pair of the kernel that tests them (any_hit_work),
    and beside it a yardstick: the walk without the cull x 47."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    check(len(k.calls) >= 1, "K8: no recorded call")
    args, kwargs = k.calls[-1]
    tri, boxes, lists, counts, rays = args
    nb = counts.shape[0]
    hit, pairs = RT.any_hit_blocks(*args)
    free = RT.no_cull_boxes(tri.shape[0], tri.device)
    free_args = (tri, free, lists, counts, rays)
    hit_f, pairs_f = RT.any_hit_blocks(*free_args)
    check(torch.equal(hit, hit_f), "K8 with its cull finds other hits than "
                                   "K8 without it")
    got, want = hold_any_hit(args)
    sel, sub = any_hit_subset(*args)
    hit_p = want[0]
    pairs_fs = pairs_f.reshape(nb, RT.RB)[sel].reshape(-1)
    _, pairs_fp = RT.any_hit_blocks_plain(tri, None, *sub[2:])
    mism = sum(int((g != w).sum()) for g, w in zip(got, want)) \
        + int((pairs_fs != pairs_fp).sum())
    err = float((got[0].double() - hit_p.double()).abs().max())
    live = (rays[7] > rays[6]).reshape(nb, RT.RB)
    n_live = int(live.sum())
    hit_share = float(hit.reshape(nb, RT.RB)[live].double().mean())
    n_pairs, n_free = float(pairs.double().sum()), float(
        pairs_f.double().sum())
    log(f"K8 any_hit {nb * RT.RB} rays ({n_live} live) x {tri.shape[0]} "
        f"chunks: {hit_share:.4f} of live rays occluded; pairs tested "
        f"{n_pairs:.6g} with the cull, {n_free:.6g} without")
    log(f"K8 against its plain version on {sel.numel()} tiles "
        f"({int(live[sel].sum())} live rays): {mism} mismatches of hits "
        "(against no cull) and tested pairs (against the cull's replay; "
        "K8 without the cull against no cull) (bound: bit-exact)")
    check(mism == 0, "K8 disagrees with its plain version")
    check(0.0 < hit_share < 1.0, f"K8: occluded share {hit_share}")
    walk = k8_walk(tri, boxes, lists, counts, rays, pairs_f)
    warp_h, tile_same = warp_directions(rays)
    rc = max(walk.get("ray_chunks", 0), 1)
    log(f"K8 walk: {walk.get('ray_chunks', 0)} (live ray, walked chunk) "
        f"pairs; the segment meets the chunk's box in "
        f"{walk.get('chunk_meets', 0) / rc:.4f} of them, and "
        f"{walk.get('box_meets', 0) / rc:.4f} of its four 32-triangle "
        f"boxes on average; warps visit {walk.get('warp_visits', 0)} "
        f"chunks and stage {walk.get('staged_hoisted', 0)} boxes hoisted, "
        f"{walk.get('staged_per_pair', 0)} per pair; "
        f"{int(tile_same.sum())} of {nb} tiles have 256 bit-identical "
        f"directions, {int(warp_h.sum())} of {warp_h.numel()} warps hoist")
    ops, p_h, p_m = any_hit_work(walk, pairs, rays)
    t = timings(lambda: RT.any_hit_blocks(*args), KERNEL_SYMBOLS["any_hit"],
                10)
    ms_free = cuda_ms(lambda: RT.any_hit_blocks(*free_args), 5, 1)
    nudged = nudged_directions(rays)
    nudged_args = (tri, RT.any_hit_boxes(tri, nudged), lists, counts,
                   nudged)
    _, pairs_n = RT.any_hit_blocks(*nudged_args)
    ms_nudged = cuda_ms(lambda: RT.any_hit_blocks(*nudged_args), 10, 2)
    ms_nudged_free = cuda_ms(lambda: RT.any_hit_blocks(
        tri, free, lists, counts, nudged), 5, 1)
    # one box per chunk: each of the four boxes replaced by their union
    union = torch.cat([boxes[:, 0:3].amin(-1, keepdim=True),
                       boxes[:, 3:6].amax(-1, keepdim=True)], 1) \
        .expand(-1, -1, RT.N_CULL).contiguous()
    chunk_args = (tri, union, lists, counts, rays)
    _, pairs_u = RT.any_hit_blocks(*chunk_args)
    ms_chunk = cuda_ms(lambda: RT.any_hit_blocks(*chunk_args), 10, 2)
    ms_sub = cuda_ms(lambda: RT.any_hit_blocks(*sub), 10, 2)
    plain_ms = cuda_ms(lambda: RT.any_hit_blocks_plain(*sub), 1, 0)
    yard_ms, _ = bound(0.0, n_free * ANY_HIT_FLOPS_PER_PAIR)
    log(f"K8 times: kernel {t['event_ms']:.4f} ms (device "
        f"{t['device_ms']} ms, host {t['host_us']:.1f} us); without the "
        f"cull {ms_free:.4f} ms; one box per chunk "
        f"({float(pairs_u.double().sum()):.6g} pairs) {ms_chunk:.4f} ms; "
        f"per-pair path (nudged directions, "
        f"{float(pairs_n.double().sum()):.6g} pairs) {ms_nudged:.4f} ms, "
        f"without the cull {ms_nudged_free:.4f} ms; on the {sel.numel()} "
        f"tiles kernel {ms_sub:.4f} ms, plain {plain_ms:.2f} ms; "
        f"yardstick bound (no cull, 47 a pair) {yard_ms:.4f} ms")
    # no PyTorch call traces rays: no library yardstick
    return [dict(with_bound(
        dict(max_abs_err=err, mismatches=mism, exact=True,
             ms=t["event_ms"], device_ms=t["device_ms"],
             host_us=t["host_us"], plain_ms=plain_ms, ms_no_cull=ms_free,
             ms_per_pair_path=ms_nudged,
             ms_per_pair_path_no_cull=ms_nudged_free,
             ms_chunk_boxes=ms_chunk,
             pairs_chunk_boxes=float(pairs_u.double().sum()),
             ms_on_plain_tiles=ms_sub,
             plain_on=f"{sel.numel()} of {nb} tiles",
             pairs=n_pairs, pairs_hoisted=p_h, pairs_per_pair_path=p_m,
             pairs_no_cull=n_free, yardstick_bound_ms=yard_ms, walk=walk,
             tiles_one_direction=int(tile_same.sum()),
             warps_hoisting=int(warp_h.sum())),
        nbytes(tri, boxes, lists, counts, rays, hit, pairs), ops),
        name="any_hit")]


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
        t = timings(lambda: W.warp_resample(**a),
                    KERNEL_SYMBOLS["warp_resample"], 20)
        log(f"K10 {a['mode']}{' wrap_x' if a['wrap_x'] else ''} "
            f"{tuple(a['tex'].shape)} -> {tuple(got.shape)}: max |diff| "
            f"{err:.3g} (bound: bit-exact); CUDA events {t['event_ms']:.4f} "
            f"ms, device {t['device_ms']} ms, host {t['host_us']:.1f} us")
        check(torch.equal(got, want), "K10 is not bit-exact on the path")
        if a["mode"] == "catmull_rom":
            taa = a["tex"]
    check(taa is not None, "K10: no TAA call recorded")
    _, h, w = taa.shape
    sx, sy = synthetic_field(h, w, taa.device)
    fields = {"smooth": (sx, sy),
              "far": ((sx + 500.0).contiguous(), (sy - 300.0).contiguous())}
    times = measure_warp(taa, sx, sy)
    one = measure_warp(taa[:1].contiguous(), sx, sy)  # TemporalAO's width
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
        plain_ms = cuda_ms(lambda: W.warp_resample_plain(taa, sx, sy, mode),
                           5, 1)
        library_ms = library_device_ms = None
        library_one = None
        if mode == "bilinear":
            lib = times["grid_sample"]
            library_ms, library_device_ms = lib["event_ms"], lib["device_ms"]
            library_one = one["grid_sample"]
            lib_err = _max_abs(grid_sample_yardstick(taa, sx, sy)()[0], out)
            log(f"K10 bilinear yardstick grid_sample: max |diff| from K10 "
                f"{lib_err:.3g} (not used by the port)")
        n_bytes, flops = warp_bound(taa, sx, sy, out, mode)
        rows.append(dict(with_bound(
            dict(max_abs_err=worst, mismatches=0, exact=True,
                 ms=times[mode]["event_ms"],
                 device_ms=times[mode]["device_ms"],
                 host_us=times[mode]["host_us"], one_channel=one[mode],
                 library_one_channel=library_one,
                 library_device_ms=library_device_ms, plain_ms=plain_ms,
                 timed_at=f"{tuple(taa.shape)}, synthetic motion"),
            n_bytes, flops, library_ms),
            name=f"warp_resample:{mode}",
            launches=launches_by_mode.get(mode, 0)))
        log(f"K10 {mode} at the TAA shape: kernel {times[mode]['event_ms']:.4f}"
            f" ms, plain {plain_ms:.4f} ms")
    return rows


def synthetic_field(h: int, w: int, dev):
    """Pixel positions of a smooth +-6 px sin/cos motion field over an
    [h, w] target (the field of tests/test_pallas_interpret.py)."""
    import torch
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev)
                            + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev)
                            + 0.5, indexing="ij")
    mx = 6.0 * torch.sin(torch.linspace(0.0, 3.0, w, device=dev))[None, :]
    my = 6.0 * torch.cos(torch.linspace(0.0, 2.0, h, device=dev))[:, None]
    return (xs + mx).contiguous(), (ys + my).contiguous()


def grid_sample_yardstick(tex, sx, sy):
    """One PyTorch call computing K10's bilinear mode clamped to the edge
    (grid_sample, border, align_corners False); no part of the port calls
    it."""
    import torch
    _, h, w = tex.shape
    grid = torch.stack([sx / w * 2.0 - 1.0, sy / h * 2.0 - 1.0], -1)[None]
    tex4 = tex[None]

    def library():
        return torch.nn.functional.grid_sample(
            tex4, grid, mode="bilinear", padding_mode="border",
            align_corners=False)
    return library


def measure_warp(tex, sx, sy, reps: int = 50) -> dict:
    """K10's CUDA-event, device and host times in each mode at one shape,
    and grid_sample's beside bilinear, measured the same ways."""
    from rtsdm_tpu_torch.ops import warp_cuda as W
    sym = KERNEL_SYMBOLS["warp_resample"]
    res = {}
    for mode in W.MODES:
        res[mode] = timings(lambda: W.warp_resample(tex, sx, sy, mode), sym,
                            reps)
    res["grid_sample"] = timings(grid_sample_yardstick(tex, sx, sy),
                                 "grid_sampler_2d", reps)
    shape = f"{tuple(tex.shape)} -> {tuple(sx.shape)}"
    for name, t in res.items():
        dev = ("not measured" if t["device_ms"] is None
               else f"{t['device_ms']:.4f} ms")
        log(f"K10 timing {name} {shape}: CUDA events {t['event_ms']:.4f} ms, "
            f"device {dev}, host enqueue {t['host_us']:.1f} us")
    return res


def raster_setup_ms(scene) -> dict:
    """Host-clock time of K1's inputs at the main path's size (the binning
    of _binned_chunks, cull boxes included) and of the cull boxes alone."""
    from rtsdm_tpu_torch.ops import raster as R
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    coef = R._setup_triangles(scene.camera.view_proj_no_jitter,
                              scene.positions, WIDTH, HEIGHT, 0.0, 0.0,
                              R.CULL_BACK)[0]
    wp = -(-WIDTH // RC.TILE_RW) * RC.TILE_RW
    hp = -(-HEIGHT // RC.TILE_RH) * RC.TILE_RH
    res = dict(binning_ms=synced_ms(lambda: raster_inputs(scene, WIDTH,
                                                          HEIGHT), 5),
               cull_boxes_ms=synced_ms(lambda: RC.cull_boxes(coef, wp, hp),
                                       5))
    log(f"K1 inputs at {WIDTH}x{HEIGHT} (host clock, synchronized): "
        f"_binned_chunks {res['binning_ms']:.3f} ms, of which cull_boxes "
        f"{res['cull_boxes_ms']:.3f} ms")
    return res


def raster_inputs(scene, w: int, h: int):
    """K1's inputs for the scene's camera at w x h, as rasterize builds
    them: (chunks, tri_boxes, lists, counts, nby, nbx)."""
    from rtsdm_tpu_torch.ops import raster as R
    return R._binned_chunks(scene.camera.view_proj_no_jitter,
                            scene.positions, w, h, 0.0, 0.0, "back")


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
FORWARD_SCRIPT = ROOT / "scripts" / "Forward.py"
SVAO_FULL_SCRIPT = ROOT / "scripts" / "SVAO.py"
SVAO_FULL_OUTPUTS = ("AmbientRef.out", "DiffuseRef.out", "AmbientTAA.colorOut",
                     "DiffuseTAA.colorOut", "DiffuseDLSS.output")
QUARTER_SCRIPT = ROOT / "scripts" / "SVAO_quarter.py"
SVAO_DEPTH_SCRIPT = ROOT / "scripts" / "SVAO_depth.py"
CONFIG_FRAMES = 3
RASTER_SD = {"SVAO": {"stochasticDepthImpl": "Raster"}}
# BASELINE config 3 (bench_configs.py:24-27): the SD map at full
# resolution with a 512-pixel guard band
DIVISOR_1 = {"SVAO": {"stochMapDivisor": 1, "stochMapGuardBand": 512}}
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
    "config3": (GRAPH_SCRIPT, "SunTemple@full", 1920, 1080, DIVISOR_1,
                GRAPH_OUTPUTS),
    "config4": (QUARTER_SCRIPT, "Bistro@full", 1920, 1080, {},
                ("ShadedTAA.colorOut", "AmbientOcclusion.out")),
    "svao_depth": (SVAO_DEPTH_SCRIPT, "Arcade@full", 1280, 720, {},
                   ("Ambient.out", "AmbientRef.out")),
    # BASELINE config 5 (bench_configs.py:31-33), animated as :51-66
    # (config_renderer); the G-buffer's motion vectors marked as well
    "config5": (GRAPH_SCRIPT, "EmeraldSquare@full", 1280, 720, {},
                GRAPH_OUTPUTS + ("GBufferRaster.mvec",)),
}
ANIMATED = ("config5",)
# each graph's AO output (its first channel is checked to lie in [0, 1])
AO_OUTPUT = {"config2": "AmbientOcclusion.out", "config1": "Ambient.out",
             "config1_suntemple": "Ambient.out", "svao_full": "AmbientRef.out",
             "config3": "AmbientOcclusion.out",
             "config4": "AmbientOcclusion.out", "svao_depth": "Ambient.out",
             "config5": "AmbientOcclusion.out"}
# AOGuidedBlur's fusion (config 4) weighs bright and dark by two ratios
# that sum to 1 only up to float32 rounding, as in the JAX package (whose
# clampResults is a no-op, as upstream): its AO may pass 1 by two ulps
AO_ROUNDING = {"config4": 2.0 ** -22}
# K10's Catmull-Rom launches a frame: one per TAA pass of the graph
TAA_PASSES = {"config2": 2, "svao_full": 2, "config3": 2, "config4": 1,
              "config5": 2}
# K10's launches a frame at least (TAA, the env map, the texture pages)
WARP_AT_LEAST = {"config5": 6}
# K2's (interpolated components, flat entries): positions, normals,
# texcoords and, where the geometry moves, last frame's positions; face
# normals and material id
K2_STATIC, K2_ANIMATED = (8, 4), (11, 4)
FLOOR = "raster:floor"          # K1 launched with its depth floor
RASTER_SD_FLOPS_PER_PAIR = 16   # raster_sd.cu: the three edge functions
                                # and the w plane (4 each), evaluated for
                                # every pixel-triangle pair its cull
                                # leaves; the tail of fragments inside is
                                # not counted


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
    if label in ANIMATED:
        m.active_graph.mark_output("GBufferRaster.mvec")
        config5_animation(m)
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
    check(0.0 <= lo and hi <= 1.0 + AO_ROUNDING.get(label, 0.0),
          f"{label}: AO outside [0, 1]: [{lo}, {hi}]")
    check(lo < 0.9, f"{label}: AO shows no occlusion anywhere (min {lo})")
    return lo, hi


def config_want(label, n_lights):
    """Launches per frame that each config's graph must make."""
    if label == "svao_depth":
        # the G-buffer raster and DepthPeeling's floored one (the Switch
        # keeps it live); SVAO (DualDepth primary, SingleDepth secondary)
        # fetches both layers in one K3 call, SVAO_ref (Raytraced) one
        # layer; no SD map, no K4, no shadows (TemporalDepthPeel's K10
        # bilinear from the second frame on)
        return {"raster": 1, FLOOR: 1, "fetch_attributes": 1,
                "fetch_all_directions": 2, "fetch_sd_packed": 0,
                "sd_trace": 0, "raster_stochastic": 0,
                "sd_trace_resident": 0, "fetch_taps_same_class": 0,
                "any_hit": 0}
    if label in ("config3", "config4", "config5"):
        # G-buffer and ForwardLighting raster; SVAO phase 1 and phase 2
        # fetch once each; the SD trace streams (K5: SunTemple's 323,202,
        # Bistro's 681,562 and EmeraldSquare's 1,036,922 triangles are
        # above 65,536); phase 2 reads the packed SD map through K4 at
        # divisor 4 (configs 4 and 5) and through the plain
        # fetch_sd_direction at divisor 1 (config 3)
        return {"raster": 2, FLOOR: 0, "fetch_attributes": 2,
                "fetch_all_directions": 2,
                "fetch_sd_packed": int(label != "config3"), "sd_trace": 1,
                "raster_stochastic": 0, "sd_trace_resident": 0,
                "fetch_taps_same_class": 0, "any_hit": n_lights}
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


def drive_config(label, kernels, per_frame=None):
    """Run a config for CONFIG_FRAMES frames; counts are zeroed just before
    and read just after every frame, and no plain version may run; K2
    interpolates K2_ANIMATED components where the geometry moves,
    K2_STATIC elsewhere. per_frame(f, out) sees each frame's outputs.
    Returns (renderer, launches summed over the frames, K10's by mode)."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import raster_cuda, warp_cuda
    script, scene, width, height, overrides, _ = CONFIGS[label]
    t0 = time.perf_counter()
    m = config_renderer(label)
    graph = m.active_graph
    n_lights = min(int(m.scene.num_lights), int(
        graph.get_pass("RayShadow").cfg["maxLights"])) \
        if "RayShadow" in graph.passes else 0
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
            check(by_mode["catmull_rom"] == TAA_PASSES.get(label, 0),
                  f"K10: {TAA_PASSES.get(label, 0)} TAA launch(es) a frame "
                  f"expected in {label}")
            check(sum(by_mode.values()) >= WARP_AT_LEAST.get(label, 0),
                  f"K10: at least {WARP_AT_LEAST.get(label, 0)} launches a "
                  f"frame expected in {label}")
            k2 = [(a[3], a[4]) for a, _ in
                  kernels_by_name(kernels)["fetch_attributes"].calls]
            k2_want = K2_ANIMATED if label in ANIMATED else K2_STATIC
            check(k2 and set(k2) == {k2_want},
                  f"{label}: K2 at (nci, nflat) {k2}, expected {k2_want}")
            if per_frame is not None:
                per_frame(f, out)
            totals.update(counts)
            modes.update(by_mode)
    return m, dict(totals), dict(modes)


def _pair_raster(args, kwargs):
    """K1 with its per-triangle cull, the plain version without it."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    return (RC.raster_blocks(*args, **kwargs),
            RC.raster_blocks_plain(args[0], None, *args[2:], **kwargs))


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


def _pair_any_hit(args, kwargs, tiles=ANY_HIT_TILES):
    """On the spread tile subset (hold_any_hit)."""
    return hold_any_hit(args, tiles)


def _pair_sd_trace_resident(args, kwargs):
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    return ((RT.sd_trace_resident_blocks(*args, **kwargs),),
            (RT.sd_trace_resident_blocks_plain(*args, **kwargs),))


def _pair_warp(args, kwargs):
    from rtsdm_tpu_torch.ops import warp_cuda as W
    a = _warp_args(args, kwargs)
    return (W.warp_resample(**a),), (W.warp_resample_plain(**a),)


SD_TRACE_TILES = 128   # whole 8x32 tiles of K5's plain comparison


def sd_trace_subset(args):
    """(sel, args): up to SD_TRACE_TILES whole 8x32 tiles spread evenly
    over the tiles that hold a live ray (tmax > tmin), and K5's arguments
    cut to them. Each tile lists and walks its chunks on its own, so a
    tile's slots do not depend on the other tiles of the launch."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    rays = args[3]
    nb = rays.shape[1] // RT.RB
    sel = spread_tiles((rays[4] > rays[3]).reshape(nb, RT.RB),
                       SD_TRACE_TILES, "K5")

    def cut(a):                        # [..., nb * RB] -> the tiles of sel
        lead = a.shape[:-1]
        return a.reshape(lead + (nb, RT.RB))[..., sel, :] \
            .reshape(lead + (-1,)).contiguous()

    return sel, (args[:3] + (cut(rays),) + tuple(args[4:9])
                 + tuple(None if a is None else cut(a) for a in args[9:11]))


def _pair_sd_trace(args, kwargs):
    """K5 on the spread tile subset (sd_trace_subset) against its plain
    version (the tiles' lists by build_chunk_lists, walked in order), and
    the launch over every tile cut to the subset against the launch on
    the subset."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    full = RT.sd_trace_blocks(*args, **kwargs)
    sel, sub = sd_trace_subset(args)
    got = RT.sd_trace_blocks(*sub, **kwargs)
    nb = args[3].shape[1] // RT.RB
    return ((got, full.reshape(nb, RT.RB, -1)[sel].reshape(got.shape)),
            (RT.sd_trace_blocks_plain(*sub, **kwargs), got))


# kernel -> (args, kwargs) -> (kernel outputs, plain outputs), for the
# configs' last-frame check; K6 and K9 are held by their own phases. K8's
# plain version walks every chunk of a tile's list in turn, up to all
# 8,101 at config 5: 58 s on 128 tiles, 48 s on 32 (H100 80GB HBM3), so it
# holds 32 there to keep the new phases under 90 s
K8_HOLD_TILES = {"config5": 32}
CONFIG_PAIRS = {"raster": _pair_raster,
                "fetch_attributes": _pair_fetch_attributes,
                "fetch_all_directions": _pair_fetch_directions,
                "fetch_sd_packed": _pair_fetch_sd_packed,
                "any_hit": _pair_any_hit,
                "warp_resample": _pair_warp,
                "sd_trace_resident": _pair_sd_trace_resident,
                "sd_trace": _pair_sd_trace}


def same_call(a, b) -> bool:
    """Two recorded (args, kwargs) of one wrapper with equal arguments."""
    import torch

    def eq(x, y):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            return (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.shape == y.shape and x.dtype == y.dtype
                    and bool(torch.equal(x, y)))
        if isinstance(x, (tuple, list)) or isinstance(y, (tuple, list)):
            return (type(x) is type(y) and len(x) == len(y)
                    and all(eq(u, v) for u, v in zip(x, y)))
        return x == y

    return (len(a[0]) == len(b[0]) and a[1].keys() == b[1].keys()
            and eq(tuple(a[0]), tuple(b[0]))
            and eq(tuple(a[1].values()), tuple(b[1][k] for k in a[1])))


def distinct_calls(calls) -> list:
    """The recorded calls whose arguments differ from every earlier one."""
    out = []
    for c in calls:
        if not any(same_call(c, d) for d in out):
            out.append(c)
    return out


def _raster_only(args, kwargs):
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    return RC.raster_blocks(*args, **kwargs)


def check_config_calls(label, kernels):
    """Every call of the config's last frame, at the config's own shapes
    and settings (K1 with and without its floor, K4 at guard 0 in config 2,
    K7 in SVAO.py, K5 in configs 3 and 4),
    against its plain version on the card: bit-exact (--fmad=false, the
    plain versions' operation order; K8 and K5 on a spread subset of whole
    tiles, as in compare_any_hit). A K1 call with the arguments of an
    earlier one (config 5's G-buffer and ForwardLighting raster the same
    scene from the same camera) is held against that call's plain output,
    which the plain version would give again. Returns {kernel: calls
    held}."""
    import torch
    by_name = kernels_by_name(kernels)
    held, seconds = {}, {}
    for name, pair in CONFIG_PAIRS.items():
        calls = by_name[name].calls
        done = []        # (call, plain outputs) of the K1 calls held so far
        t0 = time.perf_counter()
        if name == "any_hit" and label in K8_HOLD_TILES:
            pair = functools.partial(pair, tiles=K8_HOLD_TILES[label])
        for args, kwargs in calls:
            prior = next((w for c, w in done
                          if same_call(c, (args, kwargs))), None) \
                if name == "raster" else None
            if prior is None:
                got, want = pair(args, kwargs)
                done.append(((args, kwargs), want))
            else:
                got, want = _raster_only(args, kwargs), prior
            for g, w in zip(got, want):
                check(g.shape == w.shape, f"{label}: {name} output shape "
                                          f"{tuple(g.shape)} vs plain "
                                          f"{tuple(w.shape)}")
                mism = int((g != w).sum())
                check(torch.equal(g, w), f"{label}: {name} at "
                                         f"{tuple(g.shape)} is not "
                                         f"bit-exact ({mism} mismatches)")
        held[name] = len(calls)
        seconds[name] = time.perf_counter() - t0
    log(f"{label}: seconds holding each kernel's calls: " + ", ".join(
        f"{n} {v:.1f}" for n, v in seconds.items()))
    log(f"{label}: the last frame's calls held bit-exact against their plain "
        f"versions: {held}")
    return held


def time_raster_calls(label, calls) -> list:
    """raster_timing at every K1 call kept from a path's last frame."""
    return [dict(raster_timing(a, kw, f"{label} call {i}"
                               + (" (floored)" if kw.get("floor") is not None
                                  else "")),
                 floored=kw.get("floor") is not None)
            for i, (a, kw) in enumerate(calls)]


def compare_raster_floor(calls):
    """K1 with its depth floor (DepthPeeling) on the last floored call:
    times, bounds, the share of pixels holding a second layer. Every
    floored call was held bit-exact by check_config_calls (--fmad=false; the
    floor test is a true division and a comparison)."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    floored = [(a, kw) for a, kw in calls if kw.get("floor") is not None]
    check(floored, "K1: no floored call recorded")
    args, kwargs = floored[-1]
    got = RC.raster_blocks(*args, **kwargs)
    peeled = float((got[1] >= 0).double().mean())
    log(f"K1 with floor {tuple(got[1].shape)}, {args[0].shape[0]} chunks, "
        f"min_separation {kwargs.get('min_separation')}: second-layer "
        f"coverage {peeled:.4f}")
    t = raster_timing(args, kwargs, "floored (DepthPeeling)")
    # no PyTorch call rasterizes triangles: no library yardstick
    return dict(t, max_abs_err=0.0, mismatches=0, exact=True,
                ms=t["event_ms"], library_ms=None,
                plain_ms=cuda_ms(lambda: RC.raster_blocks_plain(
                    args[0], None, *args[2:], **kwargs), 1, 1),
                timed_at=f"{tuple(got[1].shape)}", second_layer=peeled)


def compare_taps_same_class(calls, timed_label):
    """K6: bit-exact (a copy chosen by a table lookup) on every call kept
    from the configs' last frames; the timed row is the largest call (CUDA
    events around the wrapper, device time per call by torch.profiler)."""
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
    t = timings(lambda: F.fetch_taps_same_class(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_taps_same_class"], 50)
    log(f"K6 at {timed_label} {tuple(got.shape)}: {t['event_ms']:.4f} ms "
        f"by CUDA events, device {t['device_ms']} ms, host "
        f"{t['host_us']:.1f} us a call")
    # a copy per output; no single PyTorch call looks the offset up and
    # gathers (torch.gather needs the flat index this kernel computes): no
    # library yardstick
    return with_bound(
        dict(t, max_abs_err=0.0, mismatches=0, exact=True, ms=t["event_ms"],
             plain_ms=cuda_ms(lambda: F.fetch_taps_same_class_plain(
                 *args, **kwargs), 5, 1),
             timed_at=f"{timed_label} {tuple(got.shape)}"),
        nbytes(planes, lvl, tab, got), 0.0)


def k9_parts_timing(args, parts_list, reps: int = 20) -> dict:
    """K9 at one call with its walk split into each of parts_list, timed in
    turns (the list, then the list reversed): {parts: {event_ms: [two
    runs], device_ms: [two runs]}}."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    res = {p: {"event_ms": [], "device_ms": []} for p in parts_list}
    for order in (parts_list, parts_list[::-1]):
        for p in order:
            t = timings(lambda: RC.raster_stochastic_blocks(*args, parts=p),
                        KERNEL_SYMBOLS["raster_stochastic"], reps)
            res[p]["event_ms"].append(t["event_ms"])
            res[p]["device_ms"].append(t["device_ms"])
    for p, v in res.items():
        log(f"K9 with its walk in {p} part(s): CUDA events "
            f"{v['event_ms']} ms, device {v['device_ms']} ms")
    return res


def compare_raster_stochastic(k):
    """K9: bit-exact against the plain version without its per-triangle
    cull at the path's inputs (the last frame's call), at the path's alpha
    and at alpha 1.0 (every fragment writes floor(k + rng) slots), its walk
    whole and split, and on the same tiles with short lists that stream
    every chunk. The bound counts the pixel-triangle pairs its cull leaves
    (replayed on the host, raster_walk); bound_ms_walk, the earlier
    definition, counts every pair of the walk."""
    import torch
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    check(k.calls, "K9: no recorded call")
    args, kwargs = k.calls[-1]
    chunks, boxes, lists, counts, nby, nbx, first, rmin, rmax, kk, alpha = \
        args
    got = RC.raster_stochastic_blocks(*args, **kwargs)
    hit = float((got < RC.SD_EMPTY).double().mean())
    parts = RC.sd_parts(nby * nbx)
    log(f"K9 raster_stochastic {tuple(got.shape)}, {chunks.shape[0]} chunks, "
        f"k={kk}, alpha={alpha}, walk in {parts} part(s): slots with a "
        f"depth {hit:.4f}")
    check(0.0 < hit < 1.0, f"K9: share of filled slots {hit}")
    walk = raster_walk(chunks, boxes, lists, counts, nbx)
    visits = spread(walk_visits(lists, counts, chunks.shape[0]))
    log(f"K9 walk: {walk_line(walk)}; visits per tile {visits}")
    short = lists[:, :2].contiguous()
    for a in (alpha, 1.0):
        run = (chunks, boxes, lists, counts, nby, nbx, first, rmin, rmax, kk,
               a)
        w = RC.raster_stochastic_blocks_plain(chunks, None, *run[2:])
        for p in sorted({1, parts}):
            g = RC.raster_stochastic_blocks(*run, parts=p)
            mism = int((g != w).sum())
            log(f"K9 at alpha {a}, {p} part(s): {mism} slot mismatches of "
                f"{g.numel()} (bound: bit-exact)")
            check(torch.equal(g, w), f"K9 is not bit-exact at alpha {a}, {p} "
                                     "part(s)")
    for p in sorted({1, parts}):
        g = RC.raster_stochastic_blocks(chunks, boxes, short, *args[3:],
                                        parts=p)
        check(torch.equal(g, got), f"K9 streaming every chunk ({p} "
                                   "part(s)) disagrees with its walk")
    split = k9_parts_timing(args, sorted({1, 4, 8, 16, 32, parts}))
    t = timings(lambda: RC.raster_stochastic_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["raster_stochastic"], 20)
    pairs_walk = walk["visits"] * RC.TC * RC.RB
    n_bytes = nbytes(chunks, boxes, lists, counts, first, rmin, rmax, got)
    # no PyTorch call rasterizes triangles: no library yardstick
    return with_bound(
        dict(t, max_abs_err=0.0, mismatches=0, exact=True, ms=t["event_ms"],
             plain_ms=cuda_ms(lambda: RC.raster_stochastic_blocks_plain(
                 chunks, None, *args[2:]), 1, 0),
             parts=parts, parts_timing=split, walk=walk,
             visits_per_tile=visits, pairs=walk["pairs"],
             pairs_walk=pairs_walk,
             bound_ms_walk=bound(n_bytes, pairs_walk
                                 * RASTER_SD_FLOPS_PER_PAIR)[0],
             filled_share=hit),
        n_bytes, walk["pairs"] * RASTER_SD_FLOPS_PER_PAIR)


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
    """The configs' graphs, SVAO.py, Forward.py (CornellBox, Arcade and
    the TAA sweep) and SVAO_small.py with a 32-pixel guard band at their
    golden settings on the card, held against the committed goldens
    (tests/image_refs; the JAX package's output) by the golden runner's
    MSE bound, 2e-4 (rtsdm_tpu/testing/image_tests.py:96-100). SVAO.py's
    golden traces its SD map with K7 (CornellBox: one chunk), every frame;
    Forward.py launches K8 once a frame."""
    import numpy as np
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    res = {}
    for test, script, kind in (
            ("test_HBAO", HBAO_SCRIPT, "renderpasses"),
            ("test_SVAO_rasterSD", GRAPH_SCRIPT, "renderpasses"),
            ("test_SVAO_full", SVAO_FULL_SCRIPT, "renderpasses"),
            ("test_Forward", FORWARD_SCRIPT, "renderpasses"),
            ("test_Forward_arcade", FORWARD_SCRIPT, "renderpasses"),
            ("test_TAA_sweep", FORWARD_SCRIPT, "renderscripts"),
            ("test_SVAO_guardband", GRAPH_SCRIPT, "renderpasses")):
        ns = {}
        exec((ROOT / "tests" / "image_tests" / kind
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
        if script == FORWARD_SCRIPT:      # RayShadow: K8 once a frame
            check(LAUNCHES["rtsdm_any_hit"] == max(cfg["frames"]) + 1,
                  f"{test}: K8 launched {LAUNCHES['rtsdm_any_hit']} times")
        for name in ns.get("OUTPUTS", sorted(out)):
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
        raster_calls = time_raster_calls(label, by_name["raster"].calls)
        times, _ = graph_timing(m)
        script, scene, width, height, overrides, _ = CONFIGS[label]
        report[label] = dict(times, script=str(script.relative_to(ROOT)),
                             raster_calls=raster_calls,
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


def resident_visits(args, tiled: bool = True):
    """Chunks each K7 block visits, as float64: its world-box overlaps
    (the plain version's lists) on the SD grid's 8x32 tiles, or with
    tiled=False on blocks of 256 consecutive rays (the parent's K7)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    tri, aabb, origin, rays = args[:4]
    if tiled:
        grid = args[9] if len(args) > 9 else None
        rays = RT.grid_tile_rays(rays, *RT._grid(rays, grid))
    _, counts = RT.build_chunk_lists(aabb, origin, rays[0:3].T, rays[3],
                                     rays[4], cap=tri.shape[0])
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
    filled slots per ray under the cap, the SD pass's (pass, ctx, inputs)
    of that frame)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
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
    with sd_pass_capture() as seen:
        m.renderFrame()
    check(len(seen) == 1, "the SD pass did not run once")
    sd_pass, sd_ctx, sd_inputs = seen[0]
    base = {k: v for k, v in sd_pass.cfg.items()
            if k not in ("Implementation", "MaxCount", "pallasStream")}
    return (sd_tiers_at(m._scene_comp, sd_ctx, sd_inputs, base), capped,
            seen[0])


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
    walk = spread(visits)
    row_major = spread(resident_visits(args, tiled=False))
    log(f"K7 sd_trace_resident {out.shape[0]} rays x {out.shape[1]} slots, "
        f"{n_chunks} chunks: visits per 8x32 tile {walk}; per block of 256 "
        f"consecutive rays (the parent's blocking) {row_major}")
    ms = cuda_ms(lambda: RT.sd_trace_resident_blocks(*args, **kwargs), 10, 2)
    plain_ms = cuda_ms(lambda: RT.sd_trace_resident_blocks_plain(
        *args, **kwargs), 1, 1)
    _, a5, kw5, _ = tiers["default"]["stream"]
    ms5 = cuda_ms(lambda: RT.sd_trace_blocks(*a5, **kw5), 10, 2)
    v5 = walk_visits(*k5_lists(a5), a5[0].shape[0])
    log(f"K7 {ms:.4f} ms (plain {plain_ms:.2f} ms); K5 on the same rays "
        f"{ms5:.4f} ms ({spread(v5)})")
    return with_bound(
        dict(max_abs_err=err, mismatches=0, exact=True, ms=ms,
             plain_ms=plain_ms, timed_at=f"{tuple(out.shape)} rays x slots, "
             f"{n_chunks} chunks", chunk_visits=int(visits.sum()),
             visits_per_block=walk, visits_per_block_row_major=row_major,
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
    raster_calls = time_raster_calls(label, by_name["raster"].calls)
    tiers, capped, sd_call = svao_full_sd_phases(m)
    row = resident_row(tiers)
    row["sd_stage"] = sd_stage_split(*sd_call)
    whole = row["sd_stage"]["sd_trace_resident"]
    row.update(kernel_ms=row["ms"], ms=whole["event_ms"],
               device_ms=whole["device_ms"], wrapper_host_us=whole["host_us"])
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
                  raster_calls=raster_calls,
                  sd_tiers_bit_exact=sorted(tiers))
    del m
    return row, report


# ---------------------------------------------------------------------------
# BASELINE configs 3 and 4 (bench_configs.py:24-30) and SVAO's DualDepth and
# SingleDepth modes in scripts/SVAO.py
# ---------------------------------------------------------------------------

def sd_trace_timing(label, k) -> dict:
    """K5 at the config's last call: its launch (CUDA events, device time
    per call by torch.profiler, host enqueue), its chunk visits per 8x32
    tile and its bound (the visits' ray-triangle tests)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    check(k.calls, f"{label}: no K5 call recorded")
    args, kwargs = k.calls[-1]
    out = RT.sd_trace_blocks(*args, **kwargs)
    n_chunks = args[0].shape[0]
    visits = walk_visits(*k5_lists(args), n_chunks)
    t = timings(lambda: RT.sd_trace_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["sd_trace"], 10)
    filled = float((out != RT.INVALID).any(1).double().mean())
    res = with_bound(
        dict(t, ms=t["event_ms"], rays=out.shape[0], chunks=n_chunks,
             chunk_visits=int(visits.sum()), visits_per_block=spread(visits),
             rays_with_a_hit=filled),
        nbytes(args[:4], args[9:11], out),
        float(visits.sum()) * RT.TC * RT.RB * TRACE_FLOPS_PER_TEST)
    log(f"{label} K5: {out.shape[0]} rays ({out.shape[0] // RT.RB} tiles) x "
        f"{n_chunks} chunks, visits per tile {res['visits_per_block']}; "
        f"{res['ms']:.4f} ms by CUDA events, device {res['device_ms']} ms, "
        f"host {res['host_us']:.1f} us; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}); rays with a hit {filled:.4f}")
    return res


def k8_bound_at(label, k) -> dict:
    """K8 at a config's last-frame call: its time (CUDA events, device time
    per call by torch.profiler) and its bound as compare_any_hit counts it
    (this run's pairs x the operations per pair of the warp that tests
    them, plus the boxes staged, from the replayed walk; its bytes)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    check(k.calls, f"{label}: no K8 call recorded")
    args, _ = k.calls[-1]
    tri, boxes, lists, counts, rays = args
    hit, pairs = RT.any_hit_blocks(*args)
    free = RT.no_cull_boxes(tri.shape[0], tri.device)
    _, pairs_f = RT.any_hit_blocks(tri, free, lists, counts, rays)
    walk = k8_walk(tri, boxes, lists, counts, rays, pairs_f)
    ops, p_h, p_m = any_hit_work(walk, pairs, rays)
    t = timings(lambda: RT.any_hit_blocks(*args), KERNEL_SYMBOLS["any_hit"],
                10)
    res = with_bound(
        dict(t, ms=t["event_ms"], rays=int(rays.shape[1]),
             chunks=int(tri.shape[0]), pairs=float(pairs.double().sum()),
             pairs_hoisted=p_h, pairs_per_pair_path=p_m,
             pairs_no_cull=float(pairs_f.double().sum()), walk=walk),
        nbytes(tri, boxes, lists, counts, rays, hit, pairs), ops)
    log(f"{label} K8: {res['rays']} rays x {res['chunks']} chunks, "
        f"{res['pairs']:.6g} pairs tested ({res['pairs_no_cull']:.6g} "
        f"without the cull); {res['ms']:.4f} ms by CUDA events, device "
        f"{res['device_ms']} ms; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


def run_new_configs():
    """Phases 18-19: BASELINE config 4 (scripts/SVAO_quarter.py, Bistro@full
    1920x1080: quarter-res SVAO with dualAO, the SD trace streamed through
    K5, AOGuidedBlur) and config 3 (SVAO_small.py at stochMapDivisor 1 and
    SD guard band 512, SunTemple@full 1920x1080) through the harness:
    CONFIG_FRAMES frames with the launches of config_want, the last
    frame's calls bit-exact against their plain versions (K5 and K8 on a
    spread subset of tiles), K5 timed with its bound, every K1 call timed,
    the frame timed as in 10. Returns {label: report}."""
    report = {}
    for label in ("config4", "config3"):
        kernels = kernels_of_configs()
        by_name = kernels_by_name(kernels)
        m, totals, modes = drive_config(label, kernels)
        if label == "config3":
            log("config3: phase 2 at divisor 1 reads the SD map through "
                "the plain ao_shift.fetch_sd_direction, as the JAX package "
                "does (rtsdm_tpu/passes/svao_shift.py:578-580, XLA code, "
                "not a Pallas kernel): K4 serves divisor 4 only, so it "
                "never launches here")
        held = check_config_calls(label, kernels)
        k5 = sd_trace_timing(label, by_name["sd_trace"])
        k8 = k8_bound_at(label, by_name["any_hit"]) \
            if label == "config4" else None
        raster_calls = time_raster_calls(label, by_name["raster"].calls)
        times, _ = graph_timing(m)
        script, scene, width, height, overrides, _ = CONFIGS[label]
        report[label] = dict(times, script=str(script.relative_to(ROOT)),
                             scene=scene, width=width, height=height,
                             triangles=int(m.scene.num_triangles),
                             overrides=overrides, launches=totals,
                             warp_launches_by_mode=modes,
                             frames=CONFIG_FRAMES, bit_exact_calls=held,
                             sd_trace=k5, any_hit=k8,
                             raster_calls=raster_calls)
        del m
    return report


def svao_modes_frames() -> dict:
    """Phase 20: scripts/SVAO.py at Arcade@full 1280x720, one frame with
    SVAO's primaryDepthMode set to DualDepth after the build (DepthPeeling
    runs: K1 once with its floor; phase 1's K3 call on two plane sets;
    both held bit-exact against their plain versions, with the frame's
    other calls), then one with secondaryDepthMode SingleDepth (phase 1
    alone: no SD trace, no K4, K3 once). Counts are zeroed just before and
    read just after each frame; no plain version may run."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import raster_cuda
    label = "svao_full"
    kernels = kernels_of_configs()
    by_name = kernels_by_name(kernels)
    m = config_renderer(label)
    svao = m.active_graph.get_pass("SVAO")
    n_lights = min(int(m.scene.num_lights), int(
        m.active_graph.get_pass("RayShadow").cfg["maxLights"]))
    m.renderFrame()
    base = {k: svao.cfg[k] for k in ("primaryDepthMode",
                                     "secondaryDepthMode")}
    res = {}
    for mode, props in (("DualDepth", {"primaryDepthMode": "DualDepth"}),
                        ("SingleDepth",
                         {"secondaryDepthMode": "SingleDepth"})):
        svao.cfg.update(props)
        with record_main_path(kernels) as plain_calls:
            for k in kernels:
                k.calls.clear()
            torch.cuda.synchronize()
            LAUNCHES.clear()
            out = m.renderFrame()
            torch.cuda.synchronize()
            check(not plain_calls, f"plain versions ran: {plain_calls}")
        svao.cfg.update(base)
        counts = {k.name: k.launches for k in kernels}
        counts[FLOOR] = LAUNCHES[raster_cuda.RASTER_FLOOR_KEY]
        lo, hi = check_config_outputs(label, out)
        dual = mode == "DualDepth"
        want = {"raster": 2, FLOOR: int(dual), "fetch_attributes": 2,
                "fetch_all_directions": 1 + int(dual),
                "fetch_sd_packed": int(dual), "sd_trace": 0,
                "sd_trace_resident": int(dual), "raster_stochastic": 0,
                "fetch_taps_same_class": 0, "any_hit": n_lights}
        log(f"SVAO.py with {props}: {m.last_frame_ms:.3f} ms host clock; "
            f"launches {counts}; AO in [{lo:.4f}, {hi:.4f}]")
        check(all(counts[n] == v for n, v in want.items()),
              f"SVAO.py {mode}: launches {counts}, expected {want}")
        sets = [len(a[0]) for a, _ in by_name["fetch_all_directions"].calls]
        check(sets == ([2, 1] if dual else [1]),
              f"SVAO.py {mode}: K3 took {sets} plane sets")
        held = check_config_calls(f"SVAO.py {mode}", kernels)
        floored = sum(kw.get("floor") is not None
                      for _, kw in by_name["raster"].calls)
        check(floored == int(dual), f"{mode}: {floored} floored K1 calls held")
        res[mode] = dict(launches=counts, bit_exact_calls=held,
                         k3_plane_sets=sets, floored_k1_held=floored,
                         host_ms=m.last_frame_ms, ao_range=[lo, hi])
    log("SVAO.py DualDepth: K1 launched once with its floor and phase 1's "
        "K3 on 2 plane sets, both bit-exact with their plain versions; "
        "SingleDepth: no SD trace and no K4")
    del m
    return res


# ---------------------------------------------------------------------------
# scripts/SVAO_depth.py, SVAO's reference modes, RTAO and the quality oracle
# (phases 21-23): the brute-force ray queries of ops/rt.py are plain
# PyTorch (XLA code in the JAX package), timed here
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_rt_queries():
    """While it holds, every call of ops/rt.py's closest_hit and
    vao_interval_query is timed by CUDA events around it (synchronized
    before and after) and the yielded list gets {fn, rays, ms, args}."""
    import torch
    from rtsdm_tpu_torch.ops import rt
    seen = []
    saved = []
    for name in ("closest_hit", "vao_interval_query"):
        real = getattr(rt, name)

        def timed(scene, origins, dirs, tmin, tmax, *a, _real=real,
                  _name=name, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = _real(scene, origins, dirs, tmin, tmax, *a, **kw)
            end.record()
            torch.cuda.synchronize()
            seen.append(dict(fn=_name, rays=int(origins.shape[0]),
                             ms=start.elapsed_time(end),
                             chunk=kw.get("chunk", rt.DEFAULT_CHUNK),
                             args=(scene, origins, dirs, tmin, tmax)))
            return out

        saved.append((name, real))
        setattr(rt, name, timed)
    try:
        yield seen
    finally:
        for name, real in saved:
            setattr(rt, name, real)


def rt_query_row(q: dict, what: str) -> dict:
    """A timed query's rays, time, rays a second and the ray-triangle
    tests its culled blocks evaluated, against the brute force's."""
    from rtsdm_tpu_torch.ops import rt
    culled, brute = rt.query_tests(*q["args"], chunk=q["chunk"])
    rps = q["rays"] / (q["ms"] / 1e3) if q["ms"] > 0 else None
    row = dict(fn=q["fn"], rays=q["rays"], ms=q["ms"], rays_per_s=rps,
               tests=culled, brute_force_tests=brute,
               tests_per_s=culled / (q["ms"] / 1e3) if q["ms"] > 0 else None)
    log(f"{what}: {q['fn']} traced {q['rays']} rays in {q['ms']:.3f} ms "
        f"(CUDA events), {rps:.4g} rays/s; {culled} ray-triangle tests "
        f"evaluated ({culled / max(brute, 1):.4g} of the brute force's "
        f"{brute})")
    return row


def run_svao_depth() -> dict:
    """Phase 21: scripts/SVAO_depth.py at Arcade@full 1280x720 through the
    harness, CONFIG_FRAMES frames on a paused clock (TemporalDepthPeel holds
    a layer from frame 1): SVAO under DualDepth with the SingleDepth
    secondary mode, SVAO_ref under Raytraced at full resolution. The
    launches of config_want per frame, counted between zeroing and reading
    around each frame; the last frame's calls held bit-exact against their
    plain versions (K1 with and without its floor, K2, K3, K10 bilinear);
    both outputs finite, of the requested size, AO in [0, 1]; the RT query
    timed by CUDA events with the rays it traced; the frame timed as in
    10."""
    label = "svao_depth"
    kernels = kernels_of_configs()
    with timed_rt_queries() as queries:
        m, totals, modes = drive_config(label, kernels)
    ref_ao = m._last_outputs["AmbientRef.out"][..., 0]
    check(0.0 <= float(ref_ao.min()) and float(ref_ao.max()) <= 1.0,
          "svao_depth: AmbientRef outside [0, 1]")
    check(len(queries) == CONFIG_FRAMES
          and all(q["fn"] == "vao_interval_query" for q in queries),
          f"svao_depth: {len(queries)} RT queries in {CONFIG_FRAMES} frames")
    check(modes.get("bilinear", 0) == CONFIG_FRAMES - 1,
          f"svao_depth: TemporalDepthPeel's K10 bilinear launched "
          f"{modes.get('bilinear', 0)} times, expected {CONFIG_FRAMES - 1}")
    held = check_config_calls(label, kernels)
    rt_row = rt_query_row(queries[-1], f"{label} SVAO_ref")
    check(rt_row["rays"] > 0, "svao_depth: SVAO_ref traced no ray")
    times, _ = graph_timing(m, reps=3)
    script, scene, width, height, overrides, _ = CONFIGS[label]
    report = dict(times, script=str(script.relative_to(ROOT)), scene=scene,
                  width=width, height=height,
                  triangles=int(m.scene.num_triangles), launches=totals,
                  warp_launches_by_mode=modes, frames=CONFIG_FRAMES,
                  bit_exact_calls=held, rt_query=rt_row,
                  rt_query_ms_per_frame=[q["ms"] for q in queries])
    del m
    return report


# SVAO's reference modes in scripts/SVAO.py (phase 22): the mode, its
# properties and what differs from the graph's own launches a frame
REFERENCE_MODES = (
    ("gather", {"samplingMode": "gather"},
     {"fetch_all_directions": 0, "fetch_sd_packed": 0,
      "sd_trace_resident": 1}),
    ("HBAO", {"kernel": "HBAO"},
     {"fetch_all_directions": 2, "fetch_sd_packed": 1,
      "sd_trace_resident": 1}),
    ("Raytraced", {"secondaryDepthMode": "Raytraced"},
     {"fetch_all_directions": 1, "fetch_sd_packed": 0,
      "sd_trace_resident": 0}))


def svao_reference_modes() -> dict:
    """Phase 22: scripts/SVAO.py at Arcade@full 1280x720, one frame each
    with samplingMode gather (per-pixel phases: no K3 or K4; the SD map
    through K7), kernel HBAO (shift mode: K3 and K4 on HBAO's ring tables,
    held bit-exact) and secondaryDepthMode Raytraced (phase 1's K3, then
    the RT query, timed), set after the build; counts zeroed just before
    and read just after each frame, no plain version run, the frame's
    calls held bit-exact. Then one RTAO frame at that size (rtao_frame)."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import raster_cuda, warp_cuda
    from rtsdm_tpu_torch.utils.sampling import (AO_KERNEL_HBAO,
                                                sample_radius_table)
    label = "svao_full"
    kernels = kernels_of_configs()
    by_name = kernels_by_name(kernels)
    m = config_renderer(label)
    svao = m.active_graph.get_pass("SVAO")
    n_lights = min(int(m.scene.num_lights), int(
        m.active_graph.get_pass("RayShadow").cfg["maxLights"]))
    m.renderFrame()
    base = {k: svao.cfg[k] for k in ("samplingMode", "kernel",
                                     "secondaryDepthMode")}
    hbao_radii = tuple(float(r) for r in sample_radius_table(
        int(svao.cfg["sampleCount"]), AO_KERNEL_HBAO))
    res = {}
    for mode, props, differs in REFERENCE_MODES:
        svao.cfg.update(props)
        with timed_rt_queries() as queries, \
                record_main_path(kernels) as plain_calls:
            for k in kernels:
                k.calls.clear()
            torch.cuda.synchronize()
            LAUNCHES.clear()
            out = m.renderFrame()
            torch.cuda.synchronize()
            check(not plain_calls, f"plain versions ran: {plain_calls}")
            counts = {k.name: k.launches for k in kernels}
            counts[FLOOR] = LAUNCHES[raster_cuda.RASTER_FLOOR_KEY]
            by_mode = {md: LAUNCHES[warp_cuda.launch_key(md)]
                       for md in warp_cuda.MODES}
        svao.cfg.update(base)
        lo, hi = check_config_outputs(label, out)
        want = dict({"raster": 2, FLOOR: 0, "fetch_attributes": 2,
                     "sd_trace": 0, "raster_stochastic": 0,
                     "fetch_taps_same_class": 0, "any_hit": n_lights},
                    **differs)
        log(f"SVAO.py with {props}: {m.last_frame_ms:.3f} ms host clock; "
            f"launches {counts}; AO in [{lo:.4f}, {hi:.4f}]")
        check(all(counts[n] == v for n, v in want.items()),
              f"SVAO.py {mode}: launches {counts}, expected {want}")
        if mode == "HBAO":
            tables = [tuple(a[5]) for a, _ in by_name["fetch_all_directions"]
                      .calls] + [tuple(a[5]) for a, _ in
                                 by_name["fetch_sd_packed"].calls]
            check(len(tables) == 3 and all(t == hbao_radii for t in tables),
                  f"SVAO.py HBAO: K3/K4 took ring radii {tables}, not "
                  f"HBAO's {hbao_radii}")
        held = check_config_calls(f"SVAO.py {mode}", kernels)
        row = dict(launches=counts, warp_launches_by_mode=by_mode,
                   bit_exact_calls=held, host_ms=m.last_frame_ms,
                   ao_range=[lo, hi])
        if mode == "Raytraced":
            check(len(queries) == 1, f"Raytraced: {len(queries)} queries")
            row.update(rt_query=rt_query_row(queries[0],
                                             "SVAO.py Raytraced"))
        else:
            check(not queries, f"SVAO.py {mode}: an RT query ran")
        res[mode] = row
    del m
    res["rtao"] = rtao_frame()
    return res


def rtao_frame(scene_name="Arcade@full", width=1280, height=720) -> dict:
    """One RTAO frame on the G-buffer of `scene_name` at width x height:
    a cosine ray a pixel through closest_hit (timed by CUDA events, after a
    warm-up frame), ambient finite and in [0, 1], some pixels occluded."""
    import torch
    from rtsdm_tpu_torch.passes.ao_extra import RTAO
    from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer
    from rtsdm_tpu_torch.rendergraph.render_pass import RenderContext
    from rtsdm_tpu_torch.scene.procedural import load_scene
    scene = load_scene(scene_name, aspect=width / height, device="cuda")
    g = raster_gbuffer(scene, width, height)
    p = RTAO({})
    p.set_scene(scene)
    inputs = {"wPos": g["posW"], "faceNormal": g["faceNormalW"]}
    ctx = RenderContext(width=width, height=height, scene=scene,
                        frame_index=1, dictionary={"guardBand": 0})
    p.execute(ctx, inputs)
    with timed_rt_queries() as queries:
        t0 = time.perf_counter()
        out, _ = p.execute(ctx, inputs)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
    amb = out["ambient"]
    check(tuple(amb.shape) == (height, width)
          and bool(torch.isfinite(amb).all())
          and 0.0 <= float(amb.min()) and float(amb.max()) <= 1.0,
          "RTAO: ambient not finite in [0, 1]")
    occluded = float((amb < 1.0).float().mean())
    check(0.0 < occluded < 1.0, f"RTAO: occluded share {occluded}")
    log(f"RTAO frame, {scene_name} {width}x{height}: {frame_ms:.3f} ms host "
        f"clock, {occluded:.4f} of the pixels occluded")
    return dict(scene=scene_name, width=width, height=height,
                frame_ms=frame_ms, occluded_share=occluded,
                rt_query=rt_query_row(queries[0], "RTAO"))


def quality_row() -> dict:
    """Phase 23: one row of the quality oracle on the card
    (rtsdm_tpu_torch/tools/quality_ssim.py), BASELINE config 2 at the JAX
    tool's 640x360 on Arcade@full: SSIM of the ray-traced and the raster SD
    AO against SVAO's Raytraced reference mode, and their mean absolute
    difference. Reported, not gated."""
    from rtsdm_tpu_torch.tools import quality_ssim as Q
    t0 = time.perf_counter()
    with timed_rt_queries() as queries:
        row = Q.run_config(Q.CONFIGS[0], "cuda", rtao_frames=0)
    row["seconds_total"] = time.perf_counter() - t0
    check(len(queries) == 1, f"quality row: {len(queries)} RT queries")
    log(f"quality, config 2 ({row['scene']} {row['resolution']}, "
        f"{row['triangles']} triangles): SSIM(ray_sd, Raytraced) "
        f"{row['ssim_ray_sd_vs_raytraced']:.6f}, SSIM(raster_sd, Raytraced) "
        f"{row['ssim_raster_sd_vs_raytraced']:.6f}, mean |ray_sd - "
        f"Raytraced| {row['mean_abs_diff_ray_sd_vs_raytraced']:.6g}")
    row["rt_query"] = rt_query_row(queries[0], "quality config 2 Raytraced")
    return row


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
# the SD trace stage piece by piece, K5's and K7's resources and walks
# ---------------------------------------------------------------------------

# rt_cuda functions the SD pass calls, timed piece by piece (the wrappers
# sd_trace_stream and sd_trace_resident hold the pieces they call)
SD_PIECES = ("prep_triangles_packed", "chunk_screen_rows",
             "build_chunk_lists", "_ray_rows", "pad_tile", "tile_flatten",
             "tile_unflatten", "sd_trace_blocks", "sd_trace_resident_blocks",
             "decode_packed", "sd_trace_stream", "sd_trace_resident")


@contextlib.contextmanager
def sd_pass_capture():
    """Record (pass, ctx, inputs) of every StochasticDepthMapRT.execute."""
    from rtsdm_tpu_torch.passes.stochastic_depth import StochasticDepthMapRT
    seen = []
    real = StochasticDepthMapRT.execute

    def capture(self, ctx, inputs, state=None):
        seen.append((self, ctx, dict(inputs)))
        return real(self, ctx, inputs, state)

    StochasticDepthMapRT.execute = capture
    try:
        yield seen
    finally:
        StochasticDepthMapRT.execute = real


def sd_stage_split(sd_pass, ctx, inputs, reps: int = 10) -> dict:
    """The SD pass's execute on these inputs, whole and piece by piece:
    for each rt_cuda function of SD_PIECES that it calls, all its calls
    replayed together, by CUDA events (host work included) and host
    enqueue time; K5's or K7's kernel by torch.profiler. On the streamed
    tier build_chunk_lists is also timed when the path no longer calls it
    (`off_path`)."""
    import torch
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    real = {n: getattr(RT, n) for n in SD_PIECES}
    calls = {n: [] for n in SD_PIECES}

    def rec(n):
        def f(*a, **kw):
            calls[n].append((a, kw))
            return real[n](*a, **kw)
        return f

    for n in SD_PIECES:
        setattr(RT, n, rec(n))
    try:
        sd_pass.execute(ctx, inputs)
    finally:
        for n, fn in real.items():
            setattr(RT, n, fn)
    torch.cuda.synchronize()

    def replay(n):
        def run():
            for a, kw in calls[n]:
                real[n](*a, **kw)
        return run

    res = {"stage": dict(event_ms=cuda_ms(lambda: sd_pass.execute(
        ctx, inputs), reps, 2), host_us=host_us(lambda: sd_pass.execute(
            ctx, inputs), reps))}
    for n in SD_PIECES:
        if calls[n]:
            res[n] = dict(calls=len(calls[n]),
                          event_ms=cuda_ms(replay(n), reps, 2),
                          host_us=host_us(replay(n), reps))
    if calls["sd_trace_stream"] and not calls["build_chunk_lists"]:
        a, kw = calls["sd_trace_stream"][0]
        lists_args = (a[1], a[2], a[3], a[4], a[5], kw.get("rx"),
                      kw.get("ry"))
        res["build_chunk_lists"] = dict(
            calls=0, off_path=True,
            event_ms=cuda_ms(lambda: RT.build_chunk_lists(*lists_args),
                             reps, 2),
            host_us=host_us(lambda: RT.build_chunk_lists(*lists_args), reps))
    for n in ("sd_trace_stream", "sd_trace_resident"):
        if calls[n]:
            res[n]["device_ms"] = device_ms(replay(n), "sd_trace", reps)
    log("SD stage split (CUDA events ms / host us): " + "; ".join(
        f"{n} {v['event_ms']:.4f} / {v['host_us']:.1f}"
        + (" (off the path)" if v.get("off_path") else "")
        + (f", device {v['device_ms']:.4f}" if v.get("device_ms") else "")
        for n, v in res.items()))
    return res


def spread(visits) -> dict:
    """Max, mean and tail of the chunk visits per block (float64 tensor)."""
    import torch
    v = visits.double().cpu()
    q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return dict(blocks=int(v.numel()), total=int(v.sum()),
                mean=float(v.mean()), p50=float(q[0]), p90=float(q[1]),
                p99=float(q[2]), max=int(v.max()))


# sm_90's limits a block's resources count against (occupancy)
SM_REGS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32
SM_SHARED, BLOCK_SHARED_RESERVED = 233472, 1024
SD_THREADS = 256    # K5's and K7's block (the parent's too)


def sd_trace_resources() -> dict:
    """Registers a thread, static shared and local bytes of K5's and K7's
    k = 4 kernels (with the back-face cull, where it is a template
    parameter) as the imported package built them, read from its
    sd_trace library by cuobjdump --dump-resource-usage, and the blocks
    of 256 threads an SM holds by them (sm_90's limits; registers are
    allocated 256 a warp)."""
    import re
    from rtsdm_tpu_torch import _build
    src = _build.CSRC_DIR / "sd_trace.cu"
    headers = sorted(_build.CSRC_DIR.glob("*.cuh"))
    digest = _build._digest([src, *headers], _build.NVCC_FLAGS)
    lib = _build.BUILD_DIR / f"librtsdm_sd_trace_{digest}.so"
    check(lib.exists(), f"{lib} is not built")
    dump = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"),
         "--dump-resource-usage", str(lib)],
        capture_output=True, text=True, timeout=120, check=True).stdout
    res = {}
    for m in re.finditer(r"Function \S*?\d+(sd_trace_kernel|"
                         r"sd_trace_resident_kernel)ILi4E(?:Lb1E)?E\S*:"
                         r"\s*REG:(\d+) STACK:\d+ SHARED:(\d+) LOCAL:(\d+)",
                         dump):
        name = m.group(1).replace("_kernel", "")
        regs, shared, local = (int(g) for g in m.group(2, 3, 4))
        warps = SD_THREADS // 32
        by_regs = SM_REGS // (-(-regs * 32 // 256) * 256) // warps
        by_shared = SM_SHARED // (-(-shared // 128) * 128
                                  + BLOCK_SHARED_RESERVED)
        res[name] = dict(registers=regs, shared_bytes=shared,
                         local_bytes=local, threads=SD_THREADS,
                         blocks_per_sm=min(by_regs, by_shared, SM_BLOCKS,
                                           SM_THREADS // SD_THREADS))
    check(set(res) == {"sd_trace", "sd_trace_resident"},
          f"cuobjdump listed {sorted(res)} of K5 and K7 in {lib.name}")
    log("SD trace resources (k = 4, cuobjdump): " + "; ".join(
        f"{n}: {v['registers']} registers, {v['shared_bytes']} B shared, "
        f"{v['local_bytes']} B local, {v['threads']} threads a block, "
        f"{v['blocks_per_sm']} blocks an SM" for n, v in res.items()))
    return res


def import_checkout(root: Path):
    """Import rtsdm_tpu_torch from the checkout at `root`."""
    sys.path.insert(0, str(root))
    import rtsdm_tpu_torch
    where = Path(rtsdm_tpu_torch.__file__).resolve().parent.parent
    check(where == root.resolve(), f"rtsdm_tpu_torch imported from {where}")


def ab_child(root: Path) -> dict:
    """Run as `chip_smoke.py --ab-child ROOT` in a process of its own: the
    SD stage, piece by piece (sd_stage_split), of the SVAO path
    (SunTemple@full 1920x1080) and of scripts/SVAO.py's first frame
    (Arcade@full 1280x720), its K5's and K7's resources
    (sd_trace_resources), and K2 and K4 timed (timings) at calls recorded
    from a frame: K2 at the SVAO path's call and at the graph's 2048x1208
    one (SVAO_small.py on SunTemple@full, guard band 64), K4 at the SVAO
    path's, through the package of the checkout at ROOT."""
    import_checkout(root)
    from rtsdm_tpu_torch.scene.procedural import sun_temple
    scene = sun_temple(aspect=WIDTH / HEIGHT, detail="full", device="cuda")
    pass_, ctx = make_svao(scene, WIDTH, HEIGHT, SVAO_PROPS)
    by_name = kernels_by_name(kernels_of_path())
    k2, k4 = by_name["fetch_attributes"], by_name["fetch_sd_packed"]
    with sd_pass_capture() as seen, record_main_path([k2, k4]):
        frame(scene, pass_, ctx, WIDTH, HEIGHT)
    res = {"svao_path": sd_stage_split(*seen[0])}
    calls = {"k2_svao_path": (k2, k2.calls[0]),
             "k4_svao_path": (k4, k4.calls[0])}
    m = graph_renderer()
    k2.calls.clear()
    with record_main_path([k2]):
        m.renderFrame()
    del m
    wide = [c for c in k2.calls if tuple(c[0][0].shape) == (1208, 2048)]
    check(wide, "the graph made no 2048x1208 K2 call")
    calls["k2_graph"] = (k2, wide[0])
    for label, (k, (args, kwargs)) in calls.items():
        res[label] = timings(lambda: k.wrapper(*args, **kwargs),
                             KERNEL_SYMBOLS[k.name], 50)
    m = config_renderer("svao_full")
    with sd_pass_capture() as seen:
        m.renderFrame()
    res["svao_full"] = sd_stage_split(*seen[0])
    del m
    res["resources"] = sd_trace_resources()
    return res


def child(flag: str, root: Path) -> dict:
    """The JSON a `chip_smoke.py FLAG ROOT` child process prints last."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag,
                          str(root)], capture_output=True, text=True,
                         timeout=900)
    check(out.returncode == 0, f"{flag} {root} failed:\n"
                               f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def parent_ab(parent: Path) -> dict:
    """The parent's SD stage, K5's and K7's resources, K2 and K4 against
    this checkout's, in turns (parent, change, change, parent), each in a
    process of its own (ab_child), on this card; and the mid-size
    comparisons through the parent's kernels (mid_child, measured only).
    Returns the four runs and the parent's MSEs."""
    runs = []
    for who in ("parent", "change", "change", "parent"):
        res = child("--ab-child", parent if who == "parent" else ROOT)
        runs.append(dict(who=who, **res))
        for cell in ("svao_path", "svao_full"):
            split = res[cell]
            log(f"A/B {who} {cell}: stage {split['stage']['event_ms']:.4f} "
                "ms; " + ", ".join(
                    f"{n} {v['event_ms']:.4f} ms"
                    + (f" (device {v['device_ms']:.4f})"
                       if v.get("device_ms") else "")
                    for n, v in split.items() if n != "stage"))
        for name in ("k2_svao_path", "k2_graph", "k4_svao_path"):
            t = res[name]
            log(f"A/B {who} {name}: {t['event_ms']:.4f} ms by CUDA events, "
                f"device {t['device_ms']} ms, host {t['host_us']:.1f} us")
    mid = child("--mid-child", parent)
    log("mid size through the parent's kernels: " + ", ".join(
        f"{k} MSE {v['mse']:.4g}" for k, v in mid.items()))
    return dict(runs=runs, parent_mid_size=mid)


# ---------------------------------------------------------------------------
# the mid-size comparison with the JAX package
# ---------------------------------------------------------------------------

# the graph scripts as tests/torch_refs/make_refs.py rendered them with the
# JAX package on the CPU (tests/test_torch_refs.py checks that each file
# records these settings): SVAO_small.py; HBAO.py (BASELINE config 1) with
# HBAO's samplingMode "Shift", which the port takes on the card (hazard l);
# config 2, SVAO_small.py with the raster SD map, the JAX package's through
# raster_stochastic_pallas, which K9 follows (hazard m)
MID_RASTER_CAPS = {p: {"maxPerTile": 4096}
                   for p in ("GBufferRaster", "DepthPeeling",
                             "ForwardLighting")}
# the raster channels each graph's AO outputs read (make_refs.py stores
# the JAX package's beside the reference): the G-buffer's depth and face
# normals, its motion vectors where a temporal pass of the AO reads them,
# DepthPeeling's floored raster where the graph keeps that pass
MID_GBUFFER_AO = ["GBufferRaster.depth", "GBufferRaster.faceNormalW"]
MID_GBUFFER_TAA = MID_GBUFFER_AO + ["GBufferRaster.mvec"]
MID_PEELED = ["DepthPeeling.depth2"]
# Graphs with a ray-traced SD map are rendered by the JAX package through
# its SD trace's Pallas kernels (its CPU tier keys and orders the samples
# otherwise) with XLA's fused multiply-adds off (they flip the samples'
# hash keys): hazard q
MID_REF = dict(script="scripts/SVAO_small.py", scene="Arcade@full",
               width=480, height=270, frames=1, frame=0,
               outputs=["AmbientOcclusion.out", "Shaded.out",
                        "AmbientOcclusionTAA.colorOut",
                        "ShadedTAA.colorOut"],
               pass_overrides=MID_RASTER_CAPS,
               shadows="RayShadow through any_hit_pallas (interpret mode)",
               ray_sd="StochasticDepthMapRT through sd_trace_pallas or "
                      "sd_trace_pallas_stream (interpret mode)",
               xla_flags="--xla_cpu_max_isa=AVX", substituted=MID_GBUFFER_TAA)
MID_HBAO_REF = dict({k: v for k, v in MID_REF.items()
                     if k not in ("ray_sd", "xla_flags")},
                    script="scripts/HBAO.py",
                    outputs=["Ambient.out", "Diffuse.out"],
                    pass_overrides={**MID_RASTER_CAPS,
                                    "HBAO": {"samplingMode": "Shift"}},
                    substituted=MID_GBUFFER_AO + MID_PEELED)
# config 2's AO also reads the raster SD map, a raster of its own; its
# reference's SVAO fetches through the fused Pallas fetches, whose phase 2
# reads the SD map packed to 16 bits as K4 does (hazard r)
MID_RASTER_SD_REF = dict(
    {k: v for k, v in MID_REF.items() if k not in ("ray_sd", "xla_flags")},
    pass_overrides={**MID_RASTER_CAPS, **RASTER_SD},
    raster_sd="StochasticDepthMap through raster_stochastic_pallas "
              "(interpret mode)",
    fused_fetch="SVAO through fetch_all_directions and fetch_sd_packed "
                "(interpret mode)",
    substituted=MID_GBUFFER_TAA + ["StochasticDepthMap.stochasticDepth"])
# MSE bound of each output against the JAX package's render: the MSE
# measured on the card through the parent commit's kernels (PERF.md section
# 6), doubled and rounded up to one digit. SVAO_small.py's (AO 3.69e-6, its
# TAA 4.70e-6, Shaded 2.54e-6, its TAA 6.28e-7): what is left is located
# in PERF.md, the rasters' last bits (tests/torch_refs/compare_passes.py
# --substitute) and the SD map's keys; the card differs from the port on
# the CPU as much. HBAO.py's (Ambient 7.514e-7, Diffuse 3.393e-6) and
# config 2's (AO 3.008e-6, its TAA 3.723e-6, Shaded 2.302e-6, its TAA
# 6.056e-7): the same order, and the port on the CPU differs as much.
# SVAO.py's (AmbientRef 3.69e-6, DiffuseRef 2.545e-6, AmbientTAA
# 4.703e-6, DiffuseTAA 6.281e-7): SVAO_small.py's through K7 to the last
# digit (frame 0, TemporalAO disabled: the same AO, shading and TAA).
# The references of SVAO_small.py, config 2 and SVAO.py now take
# the accelerator's branches of hazards q and r, and the card equals the
# CPU port to the last digit: AO 2.276e-6 (config 2 2.785e-6), HBAO.py's
# Ambient 1.65e-6, each under its bound.
MID_MSE_BOUND = {"AmbientOcclusion.out": 8e-6,
                 "AmbientOcclusionTAA.colorOut": 1e-5,
                 "Shaded.out": 6e-6, "ShadedTAA.colorOut": 2e-6}
MID_HBAO_BOUND = {"Ambient.out": 2e-6, "Diffuse.out": 7e-6}
MID_RASTER_SD_BOUND = {"AmbientOcclusion.out": 7e-6,
                       "AmbientOcclusionTAA.colorOut": 8e-6,
                       "Shaded.out": 5e-6, "ShadedTAA.colorOut": 2e-6}
# scripts/SVAO.py, the reference's shipped graph: its DepthPass capped too
# (hazard f; the graph prunes it and DepthPeeling, so only GBufferRaster
# and ForwardLighting raster), DiffuseDLSS.output (a pass-through stub)
# not kept
MID_SVAO_FULL_REF = dict(
    MID_REF, script="scripts/SVAO.py",
    outputs=["AmbientRef.out", "DiffuseRef.out", "AmbientTAA.colorOut",
             "DiffuseTAA.colorOut"],
    pass_overrides={**MID_RASTER_CAPS, "DepthPass": {"maxPerTile": 4096}},
    left_out={"DiffuseDLSS.output": "DLSSPass is a pass-through stub "
                                    "(passes/stubs.py): DiffuseRef.out"})
MID_SVAO_FULL_BOUND = {"AmbientRef.out": 8e-6, "DiffuseRef.out": 6e-6,
                       "AmbientTAA.colorOut": 1e-5,
                       "DiffuseTAA.colorOut": 2e-6}
# scripts/SVAO_quarter.py (BASELINE config 4's graph: no DepthPeeling
# pass, so two raster caps) and scripts/SVAO.py with SVAO's
# primaryDepthMode set to DualDepth after the build (DepthPeeling and
# LinearizeDepth0 then run; only AmbientRef.out is kept)
MID_QUARTER_REF = dict(
    MID_REF, script="scripts/SVAO_quarter.py",
    outputs=["AmbientOcclusion.out", "ShadedTAA.colorOut"],
    pass_overrides={p: MID_RASTER_CAPS[p]
                    for p in ("GBufferRaster", "ForwardLighting")},
    substituted=MID_GBUFFER_AO)
MID_DUAL_REF = dict(
    MID_SVAO_FULL_REF, outputs=["AmbientRef.out"],
    pass_overrides={**MID_SVAO_FULL_REF["pass_overrides"],
                    "SVAO": {"primaryDepthMode": "DualDepth"}},
    left_out={**{o: "kept small: SVAO_full holds it"
                 for o in ("DiffuseRef.out", "AmbientTAA.colorOut",
                           "DiffuseTAA.colorOut")},
              **MID_SVAO_FULL_REF["left_out"]},
    substituted=MID_GBUFFER_TAA + MID_PEELED)
# Bounds fixed before the first chip run of these graphs: twice the MSE of
# the port's own CPU render against the reference, rounded up to one digit
# (SVAO_quarter.py: AO 3.245e-4, ShadedTAA 5.383e-6; SVAO.py under
# DualDepth: AmbientRef 3.173e-6). The quarter graph's AO is far from the
# reference because its inputs' differences (the rasters' last bits, the SD
# map's keys) reach the guided blur's bright/dark fusion, whose weights are
# ratios of small local deviations.
MID_QUARTER_BOUND = {"AmbientOcclusion.out": 7e-4, "ShadedTAA.colorOut": 2e-5}
MID_DUAL_BOUND = {"AmbientRef.out": 7e-6}
# scripts/SVAO_depth.py (SVAO under DualDepth over TemporalDepthPeel's
# layer, SVAO_ref under the Raytraced secondary mode): no RayShadow and no
# ForwardLighting, its two rasters capped, frame 1 kept
MID_DEPTH_REF = dict(
    script="scripts/SVAO_depth.py", scene="Arcade@full", width=480,
    height=270, frames=2, frame=1, outputs=["Ambient.out", "AmbientRef.out"],
    pass_overrides={p: MID_RASTER_CAPS[p]
                    for p in ("GBufferRaster", "DepthPeeling")},
    substituted=MID_GBUFFER_TAA)
# Bounds fixed before its first chip run: twice the CPU port's MSE,
# rounded up (Ambient 1.836e-5, AmbientRef 1.887e-5)
MID_DEPTH_BOUND = {"Ambient.out": 4e-5, "AmbientRef.out": 4e-5}
# BASELINE config 5's animation (bench_configs.py:51-66): the camera
# orbits (0, 2, 0) at radius 45 and height 14 in 8 s; the tallest 2% of
# the triangles by centroid height (node 1) oscillate 0.5 along y in 4 s;
# the clock plays. Phase 24b holds scripts/SVAO_small.py on the small
# EmeraldSquare tier (7,322 triangles: K7) so animated, frames 0-2, frame
# 2 kept (every frame's G-buffer channels stored for its substituted hold)
CONFIG5_ANIMATION = dict(
    camera_orbit=dict(center=[0.0, 2.0, 0.0], radius=45.0, height=14.0,
                      duration=8.0),
    node=1, tallest_share=50,
    node_track=dict(axis=[0.0, 1.0, 0.0], amplitude=0.5, period=4.0),
    clock="playing")
MID_ANIM_REF = dict(
    MID_REF, scene="EmeraldSquare", frames=3, frame=2,
    outputs=["AmbientOcclusion.out", "AmbientOcclusionTAA.colorOut",
             "ShadedTAA.colorOut"],
    animation=CONFIG5_ANIMATION, substituted=MID_GBUFFER_TAA)
# Bounds: twice the card's MSE, rounded up to one digit (AO 2.074e-4, its
# TAA 8.923e-5, ShadedTAA 5.089e-6; the CPU port's to the last digit):
# raster edges of a far camera over small geometry, which its substituted
# hold removes
MID_ANIM_BOUND = {"AmbientOcclusion.out": 5e-4,
                  "AmbientOcclusionTAA.colorOut": 2e-4,
                  "ShadedTAA.colorOut": 2e-5}
# file name prefix -> (settings, MSE bounds)
MID_REFS = {"SVAO_small": (MID_REF, MID_MSE_BOUND),
            "HBAO": (MID_HBAO_REF, MID_HBAO_BOUND),
            "SVAO_rasterSD": (MID_RASTER_SD_REF, MID_RASTER_SD_BOUND),
            "SVAO_full": (MID_SVAO_FULL_REF, MID_SVAO_FULL_BOUND),
            "SVAO_quarter": (MID_QUARTER_REF, MID_QUARTER_BOUND),
            "SVAO_dual": (MID_DUAL_REF, MID_DUAL_BOUND),
            "SVAO_depth": (MID_DEPTH_REF, MID_DEPTH_BOUND),
            "SVAO_anim": (MID_ANIM_REF, MID_ANIM_BOUND)}
# The substituted holds: the port renders with the JAX package's raster
# channels (`substituted`, stored beside the reference in <ref>.rasters.npz
# by make_refs.py) in place of its own rasters', so that what is left
# comes from the passes after the rasters. Bounds: twice the MSE measured
# on the card, rounded up to one digit. SVAO_depth.py's (Ambient 8.2e-16,
# AmbientRef 5.1e-14) and SVAO_quarter.py's (1.5e-12) kept from before;
# the others (AO 2.7e-15 to 3.8e-15, the AO TAA outputs 4.0e-10
# to 7.5e-10, where the TAA's history clamp turns last bits into more),
# once the references take the accelerator's branches of hazards q and r
# and the card evaluates its camera, the dither rotation and the shift
# radii on the host (before: 1.4e-6 and 1.3e-7). The shaded outputs are
# not held so: ForwardLighting rasters the scene again on its own
# (rtsdm_tpu_torch/passes/lighting.py), a raster no substitute reaches, so
# they keep the bounds above. SVAO_small.py is held through both SD tiers,
# as phase 17 renders it (MID_SUBSTITUTED_TIERS).
MID_SUBSTITUTED_BOUND = {"SVAO_quarter": {"AmbientOcclusion.out": 2e-10},
                         "SVAO_depth": {"Ambient.out": 3e-13,
                                        "AmbientRef.out": 4e-13},
                         "SVAO_small": {"AmbientOcclusion.out": 8e-15,
                                        "AmbientOcclusionTAA.colorOut": 2e-9},
                         "SVAO_rasterSD": {
                             "AmbientOcclusion.out": 8e-15,
                             "AmbientOcclusionTAA.colorOut": 2e-9},
                         "HBAO": {"Ambient.out": 6e-15},
                         "SVAO_full": {"AmbientRef.out": 8e-15,
                                       "AmbientTAA.colorOut": 2e-9},
                         "SVAO_dual": {"AmbientRef.out": 8e-15},
                         "SVAO_anim": {"AmbientOcclusion.out": 6e-15,
                                       "AmbientOcclusionTAA.colorOut": 8e-10}}
# the SD tiers (pallasStream) a substituted hold renders through
MID_SUBSTITUTED_TIERS = {"SVAO_small": {"K7": "auto", "K5": True}}
MID_ENTRIES = ("rtsdm_sd_trace", "rtsdm_sd_trace_resident",
               "rtsdm_fetch_taps_same_class", "rtsdm_raster_stochastic")


def mid_ref_file(name: str) -> Path:
    ref = MID_REFS[name][0]
    return ROOT / "tests" / "torch_refs" / (
        f"{name}.{ref['scene'].replace('@', '_')}.{ref['width']}x"
        f"{ref['height']}.f{ref['frame']}.npz")


def mid_ref(name: str):
    """The reference of MID_REFS[name], checked to record its settings."""
    import numpy as np
    want = MID_REFS[name][0]
    path = mid_ref_file(name)
    ref = np.load(path)
    recorded = json.loads(str(ref["settings"]))
    check({k: recorded.get(k) for k in want} == want,
          f"{path.name} records {recorded}, not {want}")
    return ref


def mid_rasters(name: str) -> dict:
    """The JAX package's raster channels stored beside reference `name`
    ({"<Pass>.<channel>": array}, or {"f<frame>/<Pass>.<channel>": array}
    where it renders more than one frame), checked to be the ones its
    settings list."""
    import numpy as np
    path = mid_ref_file(name).with_suffix(".rasters.npz")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    settings = MID_REFS[name][0]
    want = settings["substituted"]
    if settings["frames"] > 1:
        want = [f"f{f}/{c}" for f in range(settings["frames"]) for c in want]
    check(sorted(arrays) == sorted(want),
          f"{path.name} holds {sorted(arrays)}, not {want}")
    return arrays


@contextlib.contextmanager
def substituted_rasters(arrays: dict | None):
    """While it holds, the port's GBufferRaster, DepthPeeling and
    StochasticDepthMap (the raster SD map) return `arrays` in place of
    those channels of their own outputs: keys
    "<Pass>.<channel>" for every frame, "f<frame>/<Pass>.<channel>" for
    the frame of that ctx.frame_index (None: no change)."""
    import torch
    from rtsdm_tpu_torch.passes import depth_chain, gbuffer, stochastic_depth
    if not arrays:
        yield
        return
    classes = {"GBufferRaster": gbuffer.GBufferRaster,
               "DepthPeeling": depth_chain.DepthPeeling,
               "StochasticDepthMap": stochastic_depth.StochasticDepthMap}
    subs = collections.defaultdict(dict)     # pass -> {(frame, ch): array}
    for key, a in arrays.items():
        head, _, name = key.rpartition("/")
        pass_name, ch = name.split(".", 1)
        subs[pass_name][(int(head[1:]) if head else None, ch)] = a
    saved = []

    def wrap(cls, mine):
        real = cls.execute

        def execute(self, ctx, inputs, state=None):
            out, st = real(self, ctx, inputs, state)
            out = dict(out)
            now = {ch: a for (f, ch), a in mine.items()
                   if f is None or f == ctx.frame_index}
            check(now, f"substituted {cls.__name__}: no channel for frame "
                       f"{ctx.frame_index}")
            for ch, a in now.items():
                check(tuple(out[ch].shape) == a.shape,
                      f"substituted {cls.__name__}.{ch}: {a.shape} for "
                      f"{tuple(out[ch].shape)}")
                out[ch] = torch.as_tensor(a).to(out[ch].device,
                                                out[ch].dtype)
            return out, st

        saved.append((cls, real))
        cls.execute = execute

    for pass_name, mine in subs.items():
        wrap(classes[pass_name], mine)
    try:
        yield
    finally:
        for cls, real in saved:
            cls.execute = real


def config5_animation(m, animation: dict = CONFIG5_ANIMATION):
    """Config 5's camera path and node track on renderer `m` after its
    scene loaded (bench_configs.py:51-66): the tallest 1/tallest_share of
    the triangles by centroid height become node 1 (the JAX package's
    numpy selection on the same float32 positions), the clock plays."""
    import dataclasses

    import numpy as np
    import torch
    from rtsdm_tpu_torch.scene.animation import (AnimationController,
                                                 CameraPath, NodeTrack)
    m.cameraPath = CameraPath.orbit(**animation["camera_orbit"])
    cent = m.scene.positions.cpu().numpy().mean(1)
    sel = np.argsort(cent[:, 1])[-len(cent) // animation["tallest_share"]:]
    node = np.zeros(len(cent), np.int32)
    node[sel] = 1
    m.scene = dataclasses.replace(
        m.scene, node_id=torch.as_tensor(node, device=m.device))
    for g in m.graphs:
        g.set_scene(m.scene)
    track = animation["node_track"]
    m.animationController = AnimationController(
        {animation["node"]: NodeTrack.oscillate(
            tuple(track["axis"]), amplitude=track["amplitude"],
            period=track["period"])})
    m.clock.play()


def mid_frame(settings: dict, sd_stream=None, substitute: dict | None = None,
              device: str = "cuda"):
    """The kept frame of `settings` through the port (on the card unless
    `device` says otherwise): its marked outputs (numpy) and the launches
    of every C entry point (and mode) over the frames rendered. sd_stream
    sets the SD pass's pallasStream (SVAO_small.py: 'auto' traces
    resident, K7; True streams, K5); `substitute` hands the G-buffer
    channels it holds to the graph (substituted_rasters)."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = Renderer(settings["width"], settings["height"], device=device)
    run_script(str(ROOT / settings["script"]), m)
    for name, props in settings["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    if sd_stream is not None:
        svao = m.active_graph.get_pass("SVAO")
        base = svao._sd_pass
        svao._sd_pass = lambda _b=base, _s=sd_stream: (
            _b()[0], {**_b()[1], "pallasStream": _s})
    m.loadScene(settings["scene"])
    m.clock.pause()
    if "animation" in settings:
        config5_animation(m, settings["animation"])
    cuda = m.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    LAUNCHES.clear()
    with substituted_rasters(substitute):
        for f in range(settings["frames"]):
            m.clock.frame = f
            out = m.renderFrame()
            if f == settings["frame"]:
                kept = {k: out[k].float().cpu().numpy()
                        for k in settings["outputs"]}
    if cuda:
        torch.cuda.synchronize()
    return kept, collections.Counter(LAUNCHES)


def mid_rows(label: str, kept: dict, ref, bound: dict | None) -> dict:
    """Each marked output against the JAX package's render: its MSE, the
    share of pixels that differ at all and by more than 1e-3, and the
    largest difference, logged beside its bound."""
    import numpy as np
    res = {}
    for name, img in kept.items():
        want = ref[name]
        check(img.shape == want.shape,
              f"{label} {name}: shape {img.shape}, JAX {want.shape}")
        check(bool(np.isfinite(img).all()), f"{label} {name}: not finite")
        d = np.abs(img - want)
        d = d.max(-1) if d.ndim == 3 else d
        mse = float(((img - want) ** 2).mean())
        row = dict(mse=mse, differ=float((d > 0).mean()),
                   differ_1e3=float((d > 1e-3).mean()),
                   max_abs=float(d.max()))
        res[f"{label}.{name}"] = row
        log(f"mid size {label}, {name} vs the JAX package: MSE {mse:.4g} "
            f"(bound {bound[name] if bound else None}); pixels differing "
            f"{row['differ']:.5f}, by > 1e-3 {row['differ_1e3']:.5f}; max "
            f"|diff| {row['max_abs']:.4g}")
    if bound is not None:
        bad = {k: v["mse"] for k, v in res.items()
               if bound[k.split(".", 1)[1]] is not None
               and v["mse"] > bound[k.split(".", 1)[1]]}
        check(not bad, f"mid size: MSE above its bound: {bad}")
    return res


def mid_size_against_jax(bound: dict | None = MID_MSE_BOUND) -> dict:
    """Phase 17: SVAO_small.py at MID_REF's scene, size, pass overrides
    (the port's rasters keep no per-tile cap, so maxPerTile changes
    nothing there) and frame through the port on the card, twice:
    pallasStream 'auto' (Arcade's 38,610 triangles: the resident tier, K7)
    and True (the streamed tier, K5). Each marked output is held against
    the JAX package's render by MSE under its `bound` (None: measured
    only)."""
    ref = mid_ref("SVAO_small")
    res = {}
    for stream in ("auto", True):
        kept, launches = mid_frame(MID_REF, stream)
        n = MID_REF["frames"]
        tier = "K5" if stream is True else "K7"
        got = (launches["rtsdm_sd_trace"],
               launches["rtsdm_sd_trace_resident"])
        check(got == ((n, 0) if stream is True else (0, n)),
              f"mid size pallasStream={stream}: K5, K7 launches {got}")
        res.update(mid_rows(tier, kept, ref, bound))
    return res


def mid_configs_against_jax(bounds=(MID_HBAO_BOUND, MID_RASTER_SD_BOUND)):
    """Phase 17b: HBAO.py (K6 once a frame) and config 2 (SVAO_small.py
    with the raster SD map, K9 once a frame, the SD trace never) at the
    scene, size, pass overrides and frame of their references through the
    port on the card, each marked output held against the JAX package's
    render by MSE under its bound (None: measured only)."""
    res = {}
    n = MID_REF["frames"]
    for name, bound, want in (
            ("HBAO", bounds[0], {"rtsdm_fetch_taps_same_class": n}),
            ("SVAO_rasterSD", bounds[1], {"rtsdm_raster_stochastic": n})):
        settings = MID_REFS[name][0]
        ref = mid_ref(name)
        kept, launches = mid_frame(settings)
        launches = {e: launches[e] for e in MID_ENTRIES}
        want = {e: want.get(e, 0) for e in MID_ENTRIES}
        check(launches == want, f"mid size {name}: launches {launches}, "
                                f"expected {want}")
        res.update(mid_rows(name, kept, ref, bound))
    return res


def mid_svao_full_against_jax(bound=MID_SVAO_FULL_BOUND) -> dict:
    """Phase 17c: scripts/SVAO.py at the scene, size, pass overrides and
    frame of its reference through the port on the card, each kept output
    held against the JAX package's render by MSE under its bound (None:
    measured only). Per frame K7 launches once (Arcade's 38,610 triangles)
    and K5, K6 and K9 never; K1 twice and never with its floor, K2 and K3
    twice, K4 once, K8 and TAA's two K10 calls."""
    from rtsdm_tpu_torch.ops import raster_cuda, warp_cuda
    settings = MID_REFS["SVAO_full"][0]
    ref = mid_ref("SVAO_full")
    kept, launches = mid_frame(settings)
    n = settings["frames"]
    want = dict({e: 0 for e in MID_ENTRIES}, rtsdm_sd_trace_resident=n,
                rtsdm_raster_blocks=2 * n, rtsdm_fetch_attributes=2 * n,
                rtsdm_fetch_directions=2 * n, rtsdm_fetch_sd_packed=n)
    want[raster_cuda.RASTER_FLOOR_KEY] = 0
    want[warp_cuda.launch_key("catmull_rom")] = 2 * n
    got = {e: launches[e] for e in want}
    check(got == want and launches["rtsdm_any_hit"] >= n,
          f"mid size SVAO_full: launches {dict(launches)}, expected {want} "
          f"and K8 at least once a frame")
    return mid_rows("SVAO_full", kept, ref, bound)


def config_launches(report: dict, row: str) -> int:
    """Launches over a config's frames of a kernel row (K10's rows are per
    mode, K1's floored launches have a row of their own)."""
    base, _, mode = row.partition(":")
    if base == "warp_resample" and mode:
        return report["warp_launches_by_mode"].get(mode, 0)
    return report["launches"].get(row if row == FLOOR else base, 0)


def mid_new_graphs_against_jax(
        bounds=(MID_QUARTER_BOUND, MID_DUAL_BOUND)) -> dict:
    """Phase 17d: scripts/SVAO_quarter.py (BASELINE config 4's graph) and
    scripts/SVAO.py under DualDepth at the scene, size, pass overrides and
    frame of their references through the port on the card, each kept
    output held against the JAX package's render by MSE under its bound.
    Arcade's 38,610 triangles: K7 once a frame, K5, K6 and K9 never; under
    DualDepth DepthPeeling's K1 once a frame with its floor, none in the
    quarter graph. This checkout only: its parent cannot render them."""
    from rtsdm_tpu_torch.ops import raster_cuda
    res = {}
    n = MID_REF["frames"]
    for name, bound in (("SVAO_quarter", bounds[0]),
                        ("SVAO_dual", bounds[1])):
        settings = MID_REFS[name][0]
        ref = mid_ref(name)
        kept, launches = mid_frame(settings)
        floor = int(name == "SVAO_dual") * n
        got = {e: launches[e] for e in MID_ENTRIES}
        want = dict({e: 0 for e in MID_ENTRIES}, rtsdm_sd_trace_resident=n)
        check(got == want and launches[raster_cuda.RASTER_FLOOR_KEY] == floor,
              f"mid size {name}: launches {dict(launches)}, expected {want} "
              f"and {floor} floored K1")
        res.update(mid_rows(name, kept, ref, bound))
    return res


def mid_svao_depth_against_jax(bound=MID_DEPTH_BOUND,
                               substituted=MID_SUBSTITUTED_BOUND) -> dict:
    """Phase 17e: scripts/SVAO_depth.py at the scene, size, pass overrides
    and frame of its reference (frames 0 and 1: TemporalDepthPeel holds
    frame 0's layer in frame 1) through the port on the card, each output
    held against the JAX package's render by MSE under its bound; per
    frame DepthPeeling's floored K1 once, no SD trace, K6 or K9. Then the
    substituted holds of every reference but SVAO_anim's (phase 24b):
    rendered with the JAX package's raster channels (mid_rasters) in place
    of the port's, their AO outputs held under MID_SUBSTITUTED_BOUND. This
    checkout only."""
    from rtsdm_tpu_torch.ops import raster_cuda
    res = {}
    settings = MID_REFS["SVAO_depth"][0]
    ref = mid_ref("SVAO_depth")
    kept, launches = mid_frame(settings)
    n = settings["frames"]
    got = {e: launches[e] for e in MID_ENTRIES}
    check(got == dict.fromkeys(MID_ENTRIES, 0)
          and launches[raster_cuda.RASTER_FLOOR_KEY] == n,
          f"mid size SVAO_depth: launches {dict(launches)}, expected no SD "
          f"trace, K6 or K9 and {n} floored K1")
    res.update(mid_rows("SVAO_depth", kept, ref, bound))
    res.update(substituted_holds(
        {k: v for k, v in substituted.items() if k != "SVAO_anim"}))
    return res


def substituted_holds(bounds: dict) -> dict:
    """Each reference of `bounds` ({name: {output: MSE bound or None}})
    rendered through the port on the card with the JAX package's raster
    channels (mid_rasters) in place of the port's, through each SD tier of
    MID_SUBSTITUTED_TIERS; its outputs in `bounds` held by MSE (None:
    measured only)."""
    res = {}
    for name, sub_bound in bounds.items():
        tiers = MID_SUBSTITUTED_TIERS.get(name, {"": None})
        for tier, stream in tiers.items():
            kept, _ = mid_frame(MID_REFS[name][0], stream,
                                substitute=mid_rasters(name))
            kept = {k: v for k, v in kept.items() if k in sub_bound}
            label = f"{name}:substituted" + (f":{tier}" if tier else "")
            res.update(mid_rows(label, kept, mid_ref(name), sub_bound))
    return res


# ---------------------------------------------------------------------------
# BASELINE config 5: scene animation, motion vectors from previous
# positions, and the sample patterns (phases 24-24c)
# ---------------------------------------------------------------------------

def k2_animated_row(k) -> dict:
    """K2 at config 5's first call of the last frame, (nci, nflat) =
    K2_ANIMATED, which takes the kernel's run-time path (only K2_STATIC is
    a template): held, timed and bounded as compare_fetch_attributes does,
    then timed beside the K2_STATIC template on the same pixels (the same
    table without its previous positions), in turns, with the time per
    output float of each."""
    import torch
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    row = compare_fetch_attributes(k)
    (tri_id, bary, table, nci, nflat), kwargs = k.calls[0]
    check((nci, nflat) == K2_ANIMATED, f"K2 at {(nci, nflat)}")
    static = torch.cat([table[:, :3 * K2_STATIC[0]],
                        table[:, 3 * nci:]], 1).contiguous()
    runs = {K2_ANIMATED: [], K2_STATIC: []}
    args = {K2_ANIMATED: (tri_id, bary, table, nci, nflat),
            K2_STATIC: (tri_id, bary, static) + K2_STATIC}
    for order in ((K2_ANIMATED, K2_STATIC), (K2_STATIC, K2_ANIMATED)):
        for key in order:
            runs[key].append(cuda_ms(lambda: RC.fetch_attributes(*args[key]),
                                     50, 3))
    per_float = {key: min(v) / (tri_id.numel() * sum(key))
                 for key, v in runs.items()}
    ratio = per_float[K2_ANIMATED] / per_float[K2_STATIC]
    log(f"K2 at {K2_ANIMATED} {tuple(tri_id.shape)} (run-time path) "
        f"{runs[K2_ANIMATED]} ms, at {K2_STATIC} (template) "
        f"{runs[K2_STATIC]} ms by CUDA events in turns; per output float "
        f"{ratio:.3f}x the template's")
    return dict(row, ms_static_template=runs[K2_STATIC],
                ms_animated_turns=runs[K2_ANIMATED],
                per_float_vs_static=ratio, nci=nci, nflat=nflat)


def fetch_rows(by_name) -> dict:
    """K3 and K4 at the path's first recorded call (held bit-exact by
    check_config_calls): CUDA-event times of the kernel and of its plain
    version, bounds as compare_fetch_directions and compare_fetch_sd_packed
    count them."""
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    (sets, pad, radius, levels, offs, radii), kw = \
        by_name["fetch_all_directions"].calls[0]
    planes = torch.stack(list(sets)).contiguous()
    k3_args = (sets, pad, radius, levels, offs, radii)
    out = torch.stack(F.fetch_all_directions(*k3_args, **kw))
    rows = {"fetch_all_directions": with_bound(
        dict(ms=cuda_ms(lambda: F.fetch_all_directions(*k3_args, **kw), 50,
                        3),
             plain_ms=cuda_ms(lambda: F.fetch_all_directions_plain(
                 planes, pad, radius.contiguous(), levels, offs, radii), 3,
                 1), timed_at=f"{tuple(out.shape)}"),
        nbytes(planes, radius, out), float(out.numel()))}
    k4_args, kw = by_name["fetch_sd_packed"].calls[0]
    sd_map, guard, radius, levels, offs, radii, _ = k4_args
    got = F.fetch_sd_packed(*k4_args, **kw)
    sd_pl = F.pack_sd16(sd_map)
    rows["fetch_sd_packed"] = with_bound(
        dict(ms=cuda_ms(lambda: F.fetch_sd_packed(*k4_args, **kw), 50, 3),
             plain_ms=cuda_ms(lambda: F.fetch_sd_packed_plain(
                 sd_pl, guard, radius.contiguous(), levels, offs, radii), 3,
                 1), timed_at=f"{tuple(got.shape)}"),
        nbytes(sd_map, radius, got), float(got.numel()))
    for n, r in rows.items():
        log(f"config5 {n} {r['timed_at']}: {r['ms']:.4f} ms by CUDA events "
            f"(plain {r['plain_ms']:.3f} ms), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return rows


def node_motion(m) -> dict:
    """The G-buffer of the last frame's animated geometry seen from a
    camera that did not move (its prev matrices its own): the motion
    vectors are the node's own motion. Their median magnitude on the
    moving node's pixels against the rest's."""
    import dataclasses

    import torch
    from rtsdm_tpu_torch.passes.gbuffer import raster_gbuffer
    t = (CONFIG_FRAMES - 1) / m.clock.framerate
    base = m._scene_comp.camera
    scene = m.animationController.animate(m._scene_comp, t)
    cam = m.cameraPath.camera_at(t, base, dt=1.0 / m.clock.framerate,
                                 aspect=float(base.aspect),
                                 focal=float(base.focal_length))
    still = dataclasses.replace(
        cam, prev_view_mat=cam.view_mat, prev_pos_w=cam.pos_w,
        prev_view_proj_no_jitter=cam.view_proj_no_jitter)
    rw, rh, _ = m._render_res()
    g = raster_gbuffer(scene.with_camera(still), rw, rh)
    tid = g["tri_id"]
    hit = tid >= 0
    on_node = hit & (scene.node_id[tid.clamp(min=0).long()] == 1)
    mag = g["mvec"].norm(dim=-1)
    res = dict(node_pixels=int(on_node.sum()),
               static_pixels=int((hit & ~on_node).sum()))
    check(res["node_pixels"] > 0, "config5: the moving node shows no pixel")
    res.update(node_median=float(mag[on_node].median()),
               static_median=float(mag[hit & ~on_node].median()))
    log(f"config5 node motion (a still camera at t = {t:.4f} s): |mvec| "
        f"median {res['node_median']:.4g} on {res['node_pixels']} pixels "
        f"of the moving node, {res['static_median']:.4g} on "
        f"{res['static_pixels']} static pixels")
    check(res["node_median"] > 10.0 * res["static_median"],
          "config5: the moving node's motion vectors do not stand out")
    torch.cuda.synchronize()
    return res


def animation_step(m) -> dict:
    """The animation step of one frame on its own (AnimationController.
    animate of the bind pose and CameraPath.camera_at): host clock ending
    in a synchronize, CUDA events, host enqueue, device time by
    torch.profiler."""
    t = m.clock.time
    base = m._scene_comp.camera

    def step():
        return (m.animationController.animate(m._scene_comp, t),
                m.cameraPath.camera_at(t, base, dt=1.0 / m.clock.framerate,
                                       aspect=float(base.aspect),
                                       focal=float(base.focal_length)))

    acts = profiled(step)
    res = dict(host_ms=synced_ms(step, 10), event_ms=cuda_ms(step, 10),
               host_enqueue_us=host_us(step, 10),
               device_ms=sum(ms for ms, _ in acts.values()),
               device_activities=sum(n for _, n in acts.values()))
    log(f"config5 animation step: host clock {res['host_ms']:.3f} ms "
        f"(synchronized), CUDA events {res['event_ms']:.3f} ms, device "
        f"{res['device_ms']:.3f} ms in {res['device_activities']} "
        f"activities")
    return res


def run_config5(ident: str) -> dict:
    """Phase 24: BASELINE config 5, scripts/SVAO_small.py on
    EmeraldSquare@full (1,036,922 triangles) at 1280x720 (1408x848 with
    the 64-pixel guard band), the camera orbiting and node 1 oscillating
    as bench_configs.py:51-66 sets them, the clock playing. Per frame the
    launches of config_want (K5 streams; K2 at K2_ANIMATED), K10 at least
    WARP_AT_LEAST; the outputs finite and AO in [0, 1]; the motion
    vectors' mean magnitude far above frame 0's (the camera moved), and
    the node's own motion (node_motion). The last frame's calls held
    bit-exact against their plain versions (K5 and K8 on spread tile
    subsets); each kernel timed with its bound; the frame timed as in 10;
    the animation step; peak device memory."""
    import torch
    label = "config5"
    kernels = kernels_of_configs()
    by_name = kernels_by_name(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    motion = []
    seconds = {}
    t0 = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        seconds[what] = now - t0[0]
        t0[0] = now

    def per_frame(f, out):
        motion.append(float(out["GBufferRaster.mvec"].norm(dim=-1).mean()))

    m, totals, modes = drive_config(label, kernels, per_frame)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"config5 ({ident}): peak device memory over the frames "
        f"{peak:.3f} GiB")
    log(f"config5 mean |mvec| per frame: {motion}")
    check(all(v > 100.0 * motion[0] for v in motion[1:]),
          "config5: the motion vectors do not show the camera's motion")
    took("frames")
    held = check_config_calls(label, kernels)
    took("held")
    node = node_motion(m)
    took("node_motion")
    rows = {"fetch_attributes": k2_animated_row(by_name["fetch_attributes"]),
            **fetch_rows(by_name)}
    took("k2_k3_k4")
    rows["sd_trace"] = sd_trace_timing(label, by_name["sd_trace"])
    took("k5")
    rows["any_hit"] = k8_bound_at(label, by_name["any_hit"])
    took("k8")
    rows.update({r["name"]: r for r in compare_warp(
        by_name["warp_resample"], modes)})
    took("k10")
    # the G-buffer's and ForwardLighting's K1 calls raster the same scene
    # from the same camera: one is timed
    raster_calls = time_raster_calls(label,
                                     distinct_calls(by_name["raster"].calls))
    took("k1")
    times, _ = graph_timing(m)
    took("frame_timing")
    step = animation_step(m)
    took("animation_step")
    script, scene, width, height, overrides, _ = CONFIGS[label]
    report = dict(times, script=str(script.relative_to(ROOT)), scene=scene,
                  width=width, height=height,
                  triangles=int(m.scene.num_triangles),
                  animation=CONFIG5_ANIMATION, launches=totals,
                  warp_launches_by_mode=modes, frames=CONFIG_FRAMES,
                  bit_exact_calls=held, mvec_mean_abs=motion,
                  node_motion=node, kernel_rows=rows,
                  raster_calls=raster_calls, animation_step=step,
                  peak_device_gib=peak, gpu=ident, seconds=seconds)
    del m
    from rtsdm_tpu_torch.tools import quality_ssim as Q
    report["taa_stability"] = Q.run_config5_taa_stability("cuda")
    took("taa_stability")
    log("config5 seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items()))
    log(f"quality, config 5 ({ident}): mean SSIM of consecutive ShadedTAA "
        f"frames 4-7 {report['taa_stability']['mean_frame_ssim']:.6f} "
        f"{report['taa_stability']['consecutive_frame_ssim']} (the JAX "
        f"tool's target {Q.TAA_STABILITY_TARGET})")
    return report


def mid_anim_against_jax(bound=MID_ANIM_BOUND,
                         sub_bound=MID_SUBSTITUTED_BOUND["SVAO_anim"]):
    """Phase 24b: SVAO_anim (config 5's animation on EmeraldSquare's
    7,322 triangles, 480x270, frames 0-2, frame 2 kept) through the port
    on the card, held against the JAX package's render by MSE, then with
    the JAX package's per-frame G-buffer channels substituted (its AO
    outputs). Per frame K7 once, K5, K6 and K9 never, K2 twice."""
    settings = MID_REFS["SVAO_anim"][0]
    kept, launches = mid_frame(settings)
    n = settings["frames"]
    got = {e: launches[e] for e in MID_ENTRIES + ("rtsdm_fetch_attributes",)}
    want = dict({e: 0 for e in MID_ENTRIES}, rtsdm_sd_trace_resident=n,
                rtsdm_fetch_attributes=2 * n)
    check(got == want, f"mid size SVAO_anim: launches {got}, expected "
                       f"{want}")
    res = mid_rows("SVAO_anim", kept, mid_ref("SVAO_anim"), bound)
    res.update(substituted_holds({"SVAO_anim": sub_bound}))
    return res


MULTISAMPLING = ("test_MultiSampling", ROOT / "samples" / "MultiSampling.py")


def multisampling_golden() -> dict:
    """Phase 24c: the golden test_MultiSampling (samples/MultiSampling.py:
    GBufferRaster with the Halton pattern of 8, AccumulatePass; CornellBox
    96x96, frame 2) on the card against the committed golden, by the
    golden runner's MSE bound (2e-4); every K1 call of its frames, whose
    G-buffer cameras carry the pattern's jitter, held bit-exact against
    its plain version."""
    import numpy as np
    import torch
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    from rtsdm_tpu_torch.utils.sampling import sample_pattern_offsets
    test, script = MULTISAMPLING
    ns = {}
    exec((ROOT / "tests" / "image_tests" / "renderpasses"
          / f"{test}.py").read_text(), ns)
    cfg = ns["IMAGE_TEST"]
    m = Renderer(cfg["width"], cfg["height"], device="cuda")
    run_script(str(script), m)
    gb = m.active_graph.get_pass("GBufferRaster").cfg
    m.loadScene(cfg["scene"])
    m.clock.pause()
    kernels = kernels_of_graph()
    k1 = kernels_by_name(kernels)["raster"]
    frames = max(cfg["frames"]) + 1
    with record_main_path(kernels) as plain_calls:
        for f in range(frames):
            m.clock.frame = f
            out = m.renderFrame()
    check(not plain_calls, f"plain versions ran: {plain_calls}")
    offs = sample_pattern_offsets(gb["samplePattern"], gb["sampleCount"])
    log(f"{test}: {gb['samplePattern']} pattern of {gb['sampleCount']}, "
        f"frames 0-{frames - 1} jittered by "
        f"{[tuple(float(x) for x in offs[f % len(offs)]) for f in range(frames)]}"
        " pixels; K1 calls " + str(len(k1.calls)))
    check(len(k1.calls) == 2 * frames, f"{test}: {len(k1.calls)} K1 calls")
    for args, kwargs in k1.calls:
        got, want = _pair_raster(args, kwargs)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{test}: K1 is not bit-exact")
    res = {"k1_calls_held": len(k1.calls)}
    for name in ns.get("OUTPUTS", sorted(out)):
        ref = np.load(ROOT / "tests" / "image_refs"
                      / f"{test}.{name}.{frames - 1}.npy")
        img = out[name].float().cpu().numpy()
        check(img.shape == ref.shape, f"{test} {name}: shape")
        mse = float(((img - ref.astype(np.float32)) ** 2).mean())
        res[f"{test}.{name}"] = mse
        log(f"{test} {name} on the card vs the committed golden: MSE "
            f"{mse:.4g} (bound 2e-4)")
        check(mse <= 2e-4, f"{test} {name}: MSE {mse} above 2e-4")
    return res


def mid_child(root: Path) -> dict:
    """Run as `chip_smoke.py --mid-child ROOT`: phases 17, 17b and 17c
    through the package of the checkout at ROOT, measured only."""
    import_checkout(root)
    return dict(mid_size_against_jax(bound=None),
                **mid_configs_against_jax(bounds=(None, None)),
                **mid_svao_full_against_jax(bound=None))

# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "NVIDIA GPU")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout of the parent commit: time "
                         "its SD stage, K2 and K4 against this one's "
                         "(parent_ab)")
    ap.add_argument("--ab-child", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mid-child", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.ab_child is not None:
        print(json.dumps(ab_child(args.ab_child)), flush=True)
        return 0
    if args.mid_child is not None:
        print(json.dumps(mid_child(args.mid_child)), flush=True)
        return 0
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
    fetch_split = fetch_host_split(
        *(kernels_by_name(kernels)[n] for n in ("fetch_all_directions",
                                                 "fetch_sd_packed")))
    gbuffer_split = gbuffer_host_split(
        scene, kernels_by_name(kernels)["fetch_attributes"])
    maxcount = maxcount_on_main_path(scene)
    raster_setup = raster_setup_ms(scene)
    resources = sd_trace_resources()
    with sd_pass_capture() as seen:
        frame(scene, pass_, ctx, WIDTH, HEIGHT)
    check(len(seen) == 1, "the SD pass did not run once")
    sd_stage = sd_stage_split(*seen[0])
    k5 = kernels_by_name(kernels)["sd_trace"].result
    k5.update(ms=sd_stage["sd_trace_stream"]["event_ms"],
              device_ms=sd_stage["sd_trace_stream"]["device_ms"],
              wrapper_host_us=sd_stage["sd_trace_stream"]["host_us"])
    log(f"K5 row: whole wrapper (sd_trace_stream, lists included) "
        f"{k5['ms']:.4f} ms by CUDA events, the launch alone "
        f"{k5['kernel_ms']:.4f} ms, device {k5['device_ms']} ms")

    torch.cuda.reset_peak_memory_stats()
    spans = frame_spans_ms(scene, pass_, ctx)
    stages = {n: spans.get(f"renderFrame/SVAO/{n}", 0.0)
              for n in ("phase1", "sd_map", "phase2")}
    stages["SVAO"] = spans.get("renderFrame/SVAO", 0.0)
    host_ms = spans.get("renderFrame", 0.0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("steady-state frame, host time per span (the program's profiler, "
        "mean of 5): " + ", ".join(f"{n} {v:.3f} ms"
                                   for n, v in spans.items()))
    log(f"steady-state frame, host clock through SVAO.execute (renderFrame, "
        f"mean of 5): {host_ms:.3f} ms; peak device memory {peak_gib:.2f} "
        "GiB")
    check(all(math.isfinite(v) and v > 0 for v in stages.values())
          and host_ms > 0, "span times")
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
    graph_raster = time_raster_calls("graph", by_name["raster"].calls)
    graph_times, _ = graph_timing(m)
    del m

    # BASELINE configs 1 and 2 (phases 11-14)
    config_rows, configs = run_configs()
    k7_row, svao_full = run_svao_full()
    config_rows.append(k7_row)
    # BASELINE configs 4 and 3 (phases 18-19), SVAO's depth modes (20)
    configs.update(run_new_configs())
    svao_modes = svao_modes_frames()
    # scripts/SVAO_depth.py (21), SVAO's reference modes and RTAO (22)
    phase_s = {}
    t0 = time.perf_counter()
    configs["svao_depth"] = run_svao_depth()
    phase_s["21"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reference_modes = svao_reference_modes()
    phase_s["22"] = time.perf_counter() - t0
    ab = parent_ab(args.parent.resolve()) if args.parent else None
    if ab is not None:
        log("phases 17d and 18-20 run on this checkout only: the parent "
            "has no DownsamplePass, AOGuidedBlur or SVAO depth modes")
    mid_size = dict(mid_size_against_jax(), **mid_configs_against_jax(),
                    **mid_svao_full_against_jax(),
                    **mid_new_graphs_against_jax())
    t0 = time.perf_counter()
    mid_size.update(mid_svao_depth_against_jax())
    phase_s["17e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quality = quality_row()
    phase_s["23"] = time.perf_counter() - t0
    # BASELINE config 5 (24), its animation at mid size (24b), the golden
    # of the sample patterns (24c)
    new_phase_s = {}
    t0 = time.perf_counter()
    configs["config5"] = run_config5(ident)
    new_phase_s["24"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mid_size.update(mid_anim_against_jax())
    new_phase_s["24b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multisampling = multisampling_golden()
    new_phase_s["24c"] = time.perf_counter() - t0
    log("earlier phases' seconds on the card: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()))
    log("new phases' seconds on the card: " + ", ".join(
        f"{k} {v:.1f}" for k, v in new_phase_s.items())
        + f"; {sum(new_phase_s.values()):.1f} in all")
    if ab is not None:
        # every kernel is bit-exact with its plain version on both sides,
        # so the parent's MSEs are this checkout's to the last digit
        moved = {k: (v["mse"], mid_size[k]["mse"])
                 for k, v in ab["parent_mid_size"].items()
                 if f"{v['mse']:.4g}" != f"{mid_size[k]['mse']:.4g}"}
        check(not moved, f"mid size: MSEs moved from the parent's: {moved}")
    rows += config_rows
    for r in rows:
        r["launches_per_frame"] = {
            lb: config_launches(configs[lb], r["name"]) / CONFIG_FRAMES
            for lb in ("config3", "config4", "svao_depth", "config5")}
        r["launches_per_frame"].update({
            f"svao_full_{md}": config_launches(reference_modes[md],
                                               r["name"])
            for md, _, _ in REFERENCE_MODES})
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
                      warp_launches_by_mode=warp_modes,
                      raster_calls=graph_raster),
        "configs": configs, "svao_full": svao_full,
        "svao_depth_modes": svao_modes,
        "svao_reference_modes": reference_modes, "quality": quality,
        "multisampling_golden": multisampling,
        "new_phase_seconds": new_phase_s, "phase_seconds": phase_s,
        "svao_path_maxcount8": maxcount, "raster_setup": raster_setup,
        "sd_stage": sd_stage, "sd_trace_resources": resources,
        "mid_size_vs_jax": mid_size, "parent_ab": ab,
        "fetch_host_split_us": fetch_split,
        "gbuffer_host_split": gbuffer_split}}))
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
