#!/usr/bin/env python3
"""Card check of the PyTorch / CUDA port (rtsdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --parent DIR     # also through the parent's package
    python3 chip_smoke.py --eye-cull SEED  # phase 25 alone

It holds the port on the card and prints each kernel's row; it times no
frame, pass or stage (benchmark/run.py and benchmark/span_report.py do).
Each phase raises on failure, and the script then exits non-zero. "Held
bit-exact" means every output equal, bit for bit, to the kernel's plain
PyTorch version on the same inputs on the card (the plain versions are
what tests/test_torch_*.py hold against the JAX package). Launch counts
are zeroed just before a frame and read just after it; no plain version
may run inside a frame.

1-3. refuse to run without a CUDA device or outside a checkout; print the
   card's name and power limit; build the CUDA kernels and the scene
   helper;
4. the SVAO path once, as bench.py drives it, at SunTemple@full 1920x1080
   (G-buffer, linearize, packed view normals, SVAO phase 1, the nested SD
   trace graph, phase 2): K1-K5 each launch, K12 once, AO finite in
   [0, 1] with some occlusion, the G-buffer covers the frame, the stencil
   and the SD map are not empty;
5. each of those six kernels against its plain version (K1 with its
   per-triangle cull against the version without it, tri_id within 1e-4 of
   the pixels, bit-exact expected; the others bit-exact, K12 at every
   call: NaN at the same texels, every other texel's bits equal); K5's key
   function on the INT_MIN hash; K4's wrapper runs its kernel and nothing
   else (torch.profiler over K4_WRAPPER_REPS calls); the SVAO path once
   more with stochMaxCount 8 (K5 with the cap, held);
7. CornellBox 64x64 on the card against the CPU's plain versions, within
   the bound of tests/test_svao.py;
8. scripts/SVAO_small.py through rtsdm_tpu_torch.mogwai at SunTemple@full
   1920x1080, 3 frames on a paused clock: per frame K1 and K2 twice, K3-K5
   and K12 as on the SVAO path, K8 once a light, K10 at least 6 times
   (TAA's two Catmull-Rom); the four outputs 1080x1920 and finite, AO in
   [0, 1];
9. the graph's last frame: K12 held as in 5 (K4's pairs on the guard
   band's [16, 302, 512] planes); K8 held on 128 spread 8x32 tiles (hits
   against the version without its per-ray cull, tested pairs against the
   cull's replay; the launch over every tile the same on those tiles; the
   same hits as with boxes that cull nothing); K10 held at every call and
   on a synthetic motion field at the TAA shape, near and far out of
   bounds;
11. BASELINE config 2 (SVAO_small.py with stochasticDepthImpl Raster,
   Arcade@full 1280x720), 3 frames: K9 once a frame, K5 never; every call
   of the last frame of K1-K4, K8 and K10 held bit-exact
   (check_config_calls), and K9 against its version without the cull at
   the path's alpha and at 1.0, its walk whole and split, and streaming
   every chunk;
12. BASELINE config 1 (scripts/HBAO.py, CornellBox 256x256), 3 frames: K6
   once, K1 once floored (DepthPeeling) besides its two; held as in 11;
   one frame under HBAO's DualDepth (K6 once on two plane sets);
13. config 1 on SunTemple@full 1920x1080, held as in 11; K6 held at every
   call kept from 12 and 13;
14. the goldens on the card: HBAO.py, config 2, SVAO.py (K7 every frame),
   Forward.py (three tests; K8 once a frame) and SVAO_small.py with a
   guard band, each output within the golden runner's MSE bound, 2e-4;
15. scripts/SVAO.py at Arcade@full 1280x720, 3 frames: K7 once a frame,
   K5 never, held as in 11 (K7 too); one frame with stochMaxCount 8 (K7
   with the cap, held); StochasticDepthMapRT at that frame's SD inputs in
   the default, kbuffer, coverage and MaxCount 8 settings on both tiers,
   each call held and K7 equal to K5 bit for bit;
16. with --parent DIR: phases 17-17c through the parent checkout's
   package in a process of its own (--mid-child), and a failure if an MSE
   differs from this checkout's in its 4th digit;
17. scripts/SVAO_small.py at its mid-size reference's settings
   (tests/torch_refs/: the JAX package's renders by make_refs.py, which
   records each one's settings in its file), frame 0, through K7 and
   through K5, each marked output within its MSE bound (MID_REFS);
17b. the same for scripts/HBAO.py (K6) and config 2 (K9);
17c. the same for scripts/SVAO.py (K7 once a frame, K1 twice and never
   floored, K2-K4, K8, K10);
17d. the same for scripts/SVAO_quarter.py and SVAO.py under DualDepth;
17e. the same for scripts/SVAO_depth.py (frame 1); then every reference
   rendered with the JAX package's raster channels (<ref>.rasters.npz) in
   place of the port's, its AO outputs within MID_SUBSTITUTED_BOUND;
18. BASELINE config 4 (scripts/SVAO_quarter.py, Bistro@full 1920x1080),
   3 frames: K5 once a frame, K7 never, K3 twice, K4 and K12 once, one
   TAA; outputs finite, AO in [0, 1]; held as in 11 (K5 and K8 on spread
   tiles);
19. BASELINE config 3 (SVAO_small.py at stochMapDivisor 1, SD guard band
   512, SunTemple@full 1920x1080), 3 frames: K5 once a frame, K4 never,
   K11 and K12 once a ring direction; held as in 11 (K11 and K12 too);
   one more frame under torch.profiler: no host-to-device copy inside SVAO
   and no miss of its table caches (frame_copies);
19b. config 2's graph at config 3's frame (SVAO_small.py with
   stochasticDepthImpl Raster, stochMapDivisor 1, SD guard band 0, Halton
   jitter, SunTemple@full 1920x1080; the benchmark's cell
   suntemple_1080p_rastersd.still), 3 frames: K9 once a frame, K5 and K4
   never, K11 (at guard 0) and K12 once a ring direction; held as in 11
   (K11 and K12 at every call), and K9 as in 11 at the frame's 2048x1208
   grid;
20. scripts/SVAO.py with SVAO's primaryDepthMode DualDepth (K1 once
   floored, phase 1's K3 on two plane sets) and secondaryDepthMode
   SingleDepth (no SD trace, no K4), one frame each, held as in 11;
21. scripts/SVAO_depth.py at Arcade@full 1280x720, 3 frames: K1 once plain
   and once floored, K2 once, K3 twice, no SD trace, K4 or shadows, K10
   bilinear from frame 1, one RT query a frame tracing rays; held as in 11;
22. scripts/SVAO.py with samplingMode gather (no K3 or K4), kernel HBAO
   (K3 and K4 on HBAO's ring radii) and secondaryDepthMode Raytraced (one
   RT query), one frame each, held as in 11; one RTAO frame, finite in
   [0, 1] with some pixels occluded;
24. BASELINE config 5 (SVAO_small.py on EmeraldSquare@full, 1,036,922
   triangles, 1280x720), animated as bench_configs.py:51-66, 3 frames:
   K1 and K2 twice (K2 interpolating last frame's positions, (nci, nflat)
   = (11, 4)), K3 twice, K4, K5 and K12 once, K8 once a light, K10 at
   least 6 times; outputs finite, AO in [0, 1]; the motion vectors show the
   camera's motion and the moving node's own; held as in 11;
24b. config 5's animation on EmeraldSquare's small tier at 480x270, frames
   0-2, against its mid-size reference, plainly and substituted;
24c. the golden test_MultiSampling (Halton jitter, CornellBox 96x96),
   every jittered K1 call held bit-exact;
25. K1's eye-plane cull in the benchmark's cells emerald_720p.orbit and
   bistro_1080p.flyby for the seed: every K1 call of each 48-frame loop
   bit-equal to K1 on the binning without the cull; at the compared frame
   the binning runs under torch.cuda.set_sync_debug_mode("error") and the
   count culled equals the one computed on the CPU.

Kernel rows: at the calls of phases 5, 9, 11-15, 18, 19, 19b and 24 each kernel
is timed one way (timings: CUDA events around the wrapper, its kernel's
device time by torch.profiler, the plain version's time) beside its bound
(the larger of bytes over 3.35 TB/s and fp32 operations over 67 TFLOP/s,
counted from the run's work: K1's and K9's walks and culls replayed, K8's
pairs and staged boxes, K5's and K7's chunk visits), a library yardstick
where one PyTorch call computes the same (K10 bilinear: grid_sample) and
its launches per frame in each config.

The last two lines are JSON: {"kernels": [...]}, one row per kernel and
path, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import json
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

    @property
    def launches(self) -> int:
        """Launches of the kernel, counted by the wrapper where it launches
        it (rtsdm_tpu_torch._build.launch)."""
        from rtsdm_tpu_torch._build import LAUNCHES
        return sum(LAUNCHES[e] for e in self.entries)


def kernels_of_path():
    from rtsdm_tpu_torch.ops import (fetch_cuda, raster_cuda, resolve_cuda,
                                     rt_cuda)
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
        Kernel("svao_resolve", ["rtsdm_svao_resolve"],
               resolve_cuda.svao_resolve, [(svao_shift, "svao_resolve")],
               [(svao_shift, "svao_resolve_plain")],
               "rtsdm_tpu_torch/csrc/svao_resolve.cu",
               "none: rtsdm_tpu/passes/svao_shift.py:svao_phase2_shift's "
               "direction loop is XLA"),
    ]


def kernels_of_graph():
    """The SVAO path's six kernels plus K8 and K10, which the graph's
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


def device_activities(fn, reps: int) -> dict:
    """{name: [device ms of each]} of the device activities torch.profiler
    recorded in `reps` calls of fn(), after one warm-up call. The profiler
    drops some records of a call's launches, never adds any."""
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
    acts = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acts[e.name].append(e.device_time_total / 1e3)
    return acts


def device_ms(fn, symbol: str, reps: int):
    """Mean device time per launch of kernel `symbol` (a substring of the
    profiler's kernel name), which fn() launches once, over the launches
    the profiler recorded in `reps` calls of fn() (device_activities: the
    mean over `reps` would understate the time); None where it saw no such
    kernel."""
    hits = [ms for name, v in device_activities(fn, reps).items()
            if symbol in name for ms in v]
    if hits and len(hits) != reps:
        log(f"torch.profiler recorded {len(hits)} launches of {symbol} in "
            f"{reps} calls")
    return sum(hits) / len(hits) if hits else None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def timings(what: str, fn, symbol: str, reps: int, plain=None) -> dict:
    """The times of a kernel row at one call, the one way every row takes
    them: fn()'s CUDA-event time over `reps` calls after 3 warm-up calls
    (`ms`, the wrapper's host work included), its kernel's device time
    per launch by torch.profiler (`device_ms`) and, where given, plain()'s
    CUDA-event time over one call after one warm-up call (`plain_ms`)."""
    t = dict(ms=cuda_ms(fn, reps, 3), device_ms=device_ms(fn, symbol, reps),
             plain_ms=None if plain is None else cuda_ms(plain, 1, 1))
    log(f"{what}: {t['ms']:.4f} ms by CUDA events, device "
        f"{ms_text(t['device_ms'])}, plain {ms_text(t['plain_ms'])}")
    return t


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
    with record_main_path(kernels) as plain_calls:
        g, out = frame(scene, pass_, ctx, WIDTH, HEIGHT)
        torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    log(f"main path, first frame: launches {counts}")
    check(not plain_calls, f"plain versions ran: {plain_calls}")
    for k in kernels:
        check(k.launches > 0, f"{k.name}: its kernel never launched on the "
                              "main path")
        check(k.calls, f"{k.name}: no recorded call")
    # divisor 4: K12 resolves the ring on K4's planes in one launch
    check(counts["svao_resolve"] == 1, f"K12 launched "
                                       f"{counts['svao_resolve']} times on "
                                       "the main path, expected 1")
    sd_map = kernels_by_name(kernels)["fetch_sd_packed"].calls[0][0][0]
    check_frame(g, out, WIDTH, HEIGHT, sd_map)
    return counts


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
    """K1's row at one call (args and kwargs of raster_cuda.raster_blocks):
    its walk and cull (raster_walk), its times (timings; the plain version
    without the cull) and both bounds: on the pairs it evaluates
    (`bound_ms`) and on every lane of every visit (`bound_ms_all_lanes`,
    the count without the cull)."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    chunks, boxes, lists, counts, nby, nbx = args
    walk = raster_walk(chunks, boxes, lists, counts, nbx)
    log(f"K1 {what} {nby * 8}x{nbx * 32}, {chunks.shape[0]} chunks: "
        f"{walk_line(walk)}")
    t = timings(f"K1 {what}", lambda: RC.raster_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["raster"], reps,
                plain=lambda: RC.raster_blocks_plain(chunks, None, *args[2:],
                                                     **kwargs))
    n_bytes = nbytes(chunks, boxes, lists, counts, kwargs.get("floor"))
    n_bytes += 16 * RC.RB * nby * nbx   # z, id, b1, b2 written, 4 B each
    b_new, by_new = bound(n_bytes, walk["flops"])
    b_old, _ = bound(n_bytes - nbytes(boxes), walk["flops_all_lanes"])
    log(f"K1 {what}: bound {b_new:.4f} ms ({by_new}) on the pairs "
        f"evaluated, {b_old:.4f} ms on every lane of every visit")
    # no PyTorch call rasterizes triangles: no library yardstick
    return dict(walk, **t, bound_ms=b_new, bound_by=by_new,
                bound_bytes=n_bytes, bound_flops=walk["flops"],
                bound_ms_all_lanes=b_old, library_ms=None)


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
    return dict(raster_timing(args, kwargs, "main path"), max_abs_err=err,
                mismatches=mism, exact=exact)


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
    t = timings(f"K2 {tuple(got.shape)}",
                lambda: RC.fetch_attributes(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_attributes"], 50,
                plain=lambda: RC.fetch_attributes_plain(*args, **kwargs))
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
        dict(t, max_abs_err=err, mismatches=0, exact=True,
             table_rows_read=rows, bound_ms_whole_table=whole),
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
    t = timings(f"K3 {tuple(got.shape)}",
                lambda: F.fetch_all_directions(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_all_directions"], 50, plain=plain)
    # a copy per output after one product radius * radii[d]; no single
    # PyTorch call selects the level and shifts: no library yardstick
    return with_bound(dict(t, max_abs_err=err, mismatches=mism, exact=True),
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
    # the profiler drops some records of a launch (device_activities), so a
    # single call can show no activity at all: hold K4_WRAPPER_REPS calls,
    # of which every recorded activity must be K4's kernel, at most one a
    # call
    acts = device_activities(lambda: F.fetch_sd_packed(*args, **kwargs),
                             K4_WRAPPER_REPS)
    own = sum(len(v) for n, v in acts.items()
              if KERNEL_SYMBOLS["fetch_sd_packed"] in n)
    others = {n: len(v) for n, v in acts.items()
              if KERNEL_SYMBOLS["fetch_sd_packed"] not in n}
    log(f"K4's wrapper on the card (torch.profiler), {K4_WRAPPER_REPS} "
        f"calls: {own} launches of its kernel, other activities {others}")
    check(not others and 1 <= own <= K4_WRAPPER_REPS,
          "K4's wrapper runs more than its kernel on the card")
    t = timings(f"K4 {tuple(got.shape)}",
                lambda: F.fetch_sd_packed(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_sd_packed"], 50, plain=plain)
    # as K3, on the 16-bit packed SD map: no library yardstick
    return with_bound(dict(t, max_abs_err=err, mismatches=mism, exact=True),
                      nbytes(sd_map, radius, got), float(got.numel()))


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
    # the launch, its lists built in the kernel; no PyTorch call traces
    # rays: no library yardstick
    t = timings(f"K5 {n} rays",
                lambda: RT.sd_trace_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["sd_trace"], 10,
                plain=lambda: RT.sd_trace_blocks_plain(*args, **kwargs))
    return with_bound(
        dict(t, max_abs_err=err, mismatches=mism,
             exact=bool(torch.equal(got, want)),
             chunk_visits=int(visits.sum()), visits_per_block=spread(visits)),
        nbytes(args[:4], args[9:11], got), tests * TRACE_FLOPS_PER_TEST)


def same_bits(got, want) -> bool:
    """NaN at the same elements (the depth at infinity gives one on both
    sides), every other element equal bit for bit."""
    import torch
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


def hold_svao_resolve(k, where: str):
    """K12: every recorded call against the plain loop, bit-exact
    (same_bits)."""
    import torch
    check(k.calls, f"K12 made no call on the {where}")
    for args, kwargs in k.calls:
        (got,), (want,) = _pair_svao_resolve(args, kwargs)
        check(got.shape == want.shape, f"K12 {tuple(got.shape)} vs plain "
                                       f"{tuple(want.shape)}")
        mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        log(f"K12 svao_resolve on the {where} {tuple(got.shape)}, SD values "
            f"{tuple(args[5].shape)} {args[5].dtype}: {mism} texels differ "
            f"in their bits, {int(torch.isnan(want).sum())} NaN in the "
            "plain loop's (bound: NaN at the same texels, the rest "
            "bit-exact)")
        check(same_bits(got, want), f"K12 is not bit-exact on the {where}")


def compare_svao_resolve(k):
    """K12 held at every call of the path; its row at the first call
    (k12_row)."""
    hold_svao_resolve(k, "main path")
    return dict(k12_row("svao_path", k), mismatches=0, exact=True)


COMPARE = {"raster": compare_raster,
           "fetch_attributes": compare_fetch_attributes,
           "fetch_all_directions": compare_fetch_directions,
           "fetch_sd_packed": compare_fetch_sd_packed,
           "sd_trace": compare_sd_trace,
           "svao_resolve": compare_svao_resolve}


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
                  "sd_trace_resident": "sd_trace_resident_kernel",
                  "fetch_sd_strided": "fetch_sd_strided_kernel",
                  "svao_resolve": "svao_resolve_kernel"}


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
    and read just after every frame. Returns (launches summed over the
    frames, K10's launches by mode)."""
    import torch
    from rtsdm_tpu_torch._build import LAUNCHES
    from rtsdm_tpu_torch.ops import warp_cuda
    m = graph_renderer()
    n_lights = min(int(m.scene.num_lights), int(
        m.active_graph.get_pass("RayShadow").cfg["maxLights"]))
    log(f"graph: {GRAPH_SCRIPT.relative_to(ROOT)} on {GRAPH_SCENE} "
        f"({m.scene.num_triangles} triangles, {n_lights} light(s)) at "
        f"{WIDTH}x{HEIGHT}")
    want = {"raster": 2 * path_counts["raster"],
            "fetch_attributes": 2 * path_counts["fetch_attributes"],
            "fetch_all_directions": path_counts["fetch_all_directions"],
            "fetch_sd_packed": path_counts["fetch_sd_packed"],
            "sd_trace": path_counts["sd_trace"],
            "svao_resolve": path_counts["svao_resolve"],
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
            log(f"graph frame {f}: launches {counts}; K10 by mode "
                f"{by_mode}; AO in [{lo:.4f}, {hi:.4f}]")
            check(not plain_calls, f"plain versions ran: {plain_calls}")
            for name, n in want.items():
                check(counts[name] == n, f"{name}: {counts[name]} launches "
                                         f"in a graph frame, expected {n}")
            check(counts["warp_resample"] >= 6, "K10 launched fewer than 6 "
                                                "times in a graph frame")
            check(by_mode["catmull_rom"] == 2, "K10: TAA x2 expected")
            totals.update(counts)
            modes.update(by_mode)
    return dict(totals), dict(modes)


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


def compare_any_hit(k):
    """K8 on the graph's last-frame call: hits bit-exact against the plain
    version without the cull and pairs against the replay of the cull, on
    ANY_HIT_TILES whole 8x32 tiles spread evenly over the tiles that hold
    a live ray (the plain version over all 2.47M rays would take too long);
    the launch over every tile gives the same answers on those tiles as its
    launch on the subset, and the same hits as K8 with boxes that cull
    nothing (whose pairs, the walk without the cull, are held against the
    plain version without the cull on the subset). The cull's yield over
    the walk (k8_walk) and the warps that hoist (warp_directions). Bound:
    the pairs this run needed x the operations per pair of the kernel that
    tests them (any_hit_work); the plain version is timed on the tiles it
    is held on."""
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
    t = timings(f"K8 {nb * RT.RB} rays (plain on {sel.numel()} tiles)",
                lambda: RT.any_hit_blocks(*args), KERNEL_SYMBOLS["any_hit"],
                10, plain=lambda: RT.any_hit_blocks_plain(*sub))
    # no PyTorch call traces rays: no library yardstick
    return with_bound(
        dict(t, max_abs_err=err, mismatches=mism, exact=True,
             plain_on=f"{sel.numel()} of {nb} tiles",
             pairs=n_pairs, pairs_hoisted=p_h, pairs_per_pair_path=p_m,
             pairs_no_cull=n_free, walk=walk,
             tiles_one_direction=int(tile_same.sum()),
             warps_hoisting=int(warp_h.sum())),
        nbytes(tri, boxes, lists, counts, rays, hit, pairs), ops)


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
    builds it). The rows are timed on the smooth field at the TAA shape;
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
            f"{err:.3g} (bound: bit-exact)")
        check(torch.equal(got, want), "K10 is not bit-exact on the path")
        if a["mode"] == "catmull_rom":
            taa = a["tex"]
    check(taa is not None, "K10: no TAA call recorded")
    _, h, w = taa.shape
    sx, sy = synthetic_field(h, w, taa.device)
    fields = {"smooth": (sx, sy),
              "far": ((sx + 500.0).contiguous(), (sy - 300.0).contiguous())}
    times = measure_warp(taa, sx, sy)
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
        library_ms = library_device_ms = None
        if mode == "bilinear":
            lib = times["grid_sample"]
            library_ms, library_device_ms = lib["ms"], lib["device_ms"]
            lib_err = _max_abs(grid_sample_yardstick(taa, sx, sy)()[0], out)
            log(f"K10 bilinear yardstick grid_sample: max |diff| from K10 "
                f"{lib_err:.3g} (not used by the port)")
        n_bytes, flops = warp_bound(taa, sx, sy, out, mode)
        rows.append(dict(with_bound(
            dict(times[mode], max_abs_err=worst, mismatches=0, exact=True,
                 library_device_ms=library_device_ms,
                 timed_at=f"{tuple(taa.shape)}, synthetic motion"),
            n_bytes, flops, library_ms),
            name=f"warp_resample:{mode}",
            launches=launches_by_mode.get(mode, 0)))
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
    """K10's times (timings) in each mode at one shape, the plain version
    beside each, and grid_sample's beside bilinear."""
    from rtsdm_tpu_torch.ops import warp_cuda as W
    shape = f"{tuple(tex.shape)} -> {tuple(sx.shape)}"
    res = {mode: timings(
        f"K10 {mode} {shape}", lambda: W.warp_resample(tex, sx, sy, mode),
        KERNEL_SYMBOLS["warp_resample"], reps,
        plain=lambda: W.warp_resample_plain(tex, sx, sy, mode))
        for mode in W.MODES}
    res["grid_sample"] = timings(f"grid_sample {shape}",
                                 grid_sample_yardstick(tex, sx, sy),
                                 "grid_sampler_2d", reps)
    return res


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
# config 2's raster SD map at config 3's frame, divisor 1 and Halton jitter,
# as the benchmark's cell suntemple_1080p_rastersd.still sets it: the map
# has no SD guard band
RASTER_SD_DIV1 = {"SVAO": {"stochasticDepthImpl": "Raster",
                           "stochMapDivisor": 1, "stochMapGuardBand": 0},
                  "GBufferRaster": {"samplePattern": "Halton",
                                    "sampleCount": 8}}
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
    "config2_suntemple": (GRAPH_SCRIPT, "SunTemple@full", 1920, 1080,
                          RASTER_SD_DIV1, GRAPH_OUTPUTS),
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
             "config2_suntemple": "AmbientOcclusion.out",
             "config4": "AmbientOcclusion.out", "svao_depth": "Ambient.out",
             "config5": "AmbientOcclusion.out"}
# AOGuidedBlur's fusion (config 4) weighs bright and dark by two ratios
# that sum to 1 only up to float32 rounding, as in the JAX package (whose
# clampResults is a no-op, as upstream): its AO may pass 1 by two ulps
AO_ROUNDING = {"config4": 2.0 ** -22}
# K10's Catmull-Rom launches a frame: one per TAA pass of the graph
TAA_PASSES = {"config2": 2, "svao_full": 2, "config3": 2, "config4": 1,
              "config5": 2, "config2_suntemple": 2}
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
    (the raster stochastic depth map), K7 (the resident SD trace) and K11
    (phase 2's SD fetch at divisors 1 and 2)."""
    from rtsdm_tpu_torch.ops import fetch_cuda, raster_cuda, rt_cuda
    from rtsdm_tpu_torch.passes import hbao, svao_shift
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
        Kernel("fetch_sd_strided", ["rtsdm_fetch_sd_strided"],
               fetch_cuda.fetch_sd_strided,
               [(svao_shift, "fetch_sd_strided")],
               [(fetch_cuda, "fetch_sd_strided_plain")],
               "rtsdm_tpu_torch/csrc/fetch.cu",
               "none: rtsdm_tpu/ops/ao_shift.py:fetch_sd_direction is XLA"),
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
                "any_hit": 0, "svao_resolve": 0}
    if label in ("config3", "config4", "config5"):
        # G-buffer and ForwardLighting raster; SVAO phase 1 and phase 2
        # fetch once each; the SD trace streams (K5: SunTemple's 323,202,
        # Bistro's 681,562 and EmeraldSquare's 1,036,922 triangles are
        # above 65,536); phase 2 reads the packed SD map through K4 at
        # divisor 4 (configs 4 and 5) and through K11 at divisor 1 (config
        # 3), one launch a ring direction; K12 resolves the ring in one
        # launch on K4's planes, once a direction after K11
        div1 = label == "config3"
        return {"raster": 2, FLOOR: 0, "fetch_attributes": 2,
                "fetch_all_directions": 2,
                "fetch_sd_packed": int(not div1),
                "fetch_sd_strided": 8 * div1,
                "svao_resolve": 8 if div1 else 1, "sd_trace": 1,
                "raster_stochastic": 0, "sd_trace_resident": 0,
                "fetch_taps_same_class": 0, "any_hit": n_lights}
    if label == "config2_suntemple":
        # G-buffer and ForwardLighting raster; K9 rasters the SD map once
        # on the unguarded 2048x1208 grid; phase 2 reads it through K11,
        # once a ring direction at guard 0, and K12 resolves after each;
        # no SD trace, no K4
        return {"raster": 2, FLOOR: 0, "fetch_attributes": 2,
                "fetch_all_directions": 2, "fetch_sd_packed": 0,
                "fetch_sd_strided": 8, "svao_resolve": 8, "sd_trace": 0,
                "raster_stochastic": 1, "sd_trace_resident": 0,
                "fetch_taps_same_class": 0, "any_hit": n_lights}
    if label in ("config2", "svao_full"):
        # G-buffer and ForwardLighting raster; SVAO phase 1 fetches both
        # ring halves, phase 2 reads the packed SD map; config 2 rasters
        # its SD map (K9), SVAO.py traces it resident (K7: Arcade's 38,610
        # triangles are at most 65,536); K5 never; K12 once
        sd9 = int(label == "config2")
        return {"raster": 2, FLOOR: 0, "fetch_attributes": 2,
                "fetch_all_directions": 2, "fetch_sd_packed": 1,
                "svao_resolve": 1,
                "sd_trace": 0, "raster_stochastic": sd9,
                "sd_trace_resident": 1 - sd9,
                "fetch_taps_same_class": 0, "any_hit": n_lights}
    # HBAO.py: G-buffer and ForwardLighting raster, DepthPeeling's floored
    # raster (live: HBAO reads depth2), one K6 call for the whole ring
    return {"raster": 2, FLOOR: 1, "fetch_attributes": 2,
            "fetch_all_directions": 0, "fetch_sd_packed": 0, "sd_trace": 0,
            "raster_stochastic": 0, "sd_trace_resident": 0,
            "fetch_taps_same_class": 1, "any_hit": n_lights,
            "svao_resolve": 0}


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
    m = config_renderer(label)
    graph = m.active_graph
    n_lights = min(int(m.scene.num_lights), int(
        graph.get_pass("RayShadow").cfg["maxLights"])) \
        if "RayShadow" in graph.passes else 0
    log(f"{label}: {script.relative_to(ROOT)} {overrides or ''} on {scene} "
        f"({m.scene.num_triangles} triangles, {n_lights} light(s)) at "
        f"{width}x{height}")
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
            log(f"{label} frame {f}: launches {counts}; K10 by mode "
                f"{by_mode}; AO in [{lo:.4f}, {hi:.4f}]")
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


def _pair_fetch_sd_strided(args, kwargs):
    """K11 against its plain version, fetch_sd_direction of the levels
    shift_level_index gives."""
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    return ((F.fetch_sd_strided(*args, **kwargs),),
            (F.fetch_sd_strided_plain(*args, **kwargs),))


def _pair_svao_resolve(args, kwargs):
    """K12 against its plain version, phase 2's direction loop, on the
    call's K3, K4 or K11 outputs and (at divisors 1 and 2) the delta the
    last direction's call returned."""
    from rtsdm_tpu_torch.ops import resolve_cuda
    from rtsdm_tpu_torch.passes import svao_shift
    return ((resolve_cuda.svao_resolve(*args, **kwargs),),
            (svao_shift.svao_resolve_plain(*args, **kwargs),))


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
                "fetch_sd_strided": _pair_fetch_sd_strided,
                "svao_resolve": _pair_svao_resolve,
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


def _raster_only(args, kwargs):
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    return RC.raster_blocks(*args, **kwargs)


def check_config_calls(label, kernels):
    """Every call of the config's last frame, at the config's own shapes
    and settings (K1 with and without its floor, K4 at guard 0 in config 2,
    K7 in SVAO.py, K5 in configs 3 and 4),
    against its plain version on the card: bit-exact (--fmad=false, the
    plain versions' operation order; K8 and K5 on a spread subset of whole
    tiles, as in compare_any_hit; K12 by same_bits). A K1 call with the
    arguments of an earlier one (config 5's G-buffer and ForwardLighting
    raster the same scene from the same camera) is held against that
    call's plain output, which the plain version would give again."""
    import torch
    by_name = kernels_by_name(kernels)
    held = {}
    for name, pair in CONFIG_PAIRS.items():
        calls = by_name[name].calls
        done = []        # (call, plain outputs) of the K1 calls held so far
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
                same = same_bits(g, w) if name == "svao_resolve" \
                    else torch.equal(g, w)
                check(same, f"{label}: {name} at {tuple(g.shape)} is not "
                            f"bit-exact ({mism} mismatches)")
        held[name] = len(calls)
    log(f"{label}: the last frame's calls held bit-exact against their plain "
        f"versions: {held}")


def compare_raster_floor(calls):
    """K1 with its depth floor (DepthPeeling) on the last floored call:
    its row (raster_timing) and the share of pixels holding a second
    layer. Every floored call was held bit-exact by check_config_calls
    (--fmad=false; the floor test is a true division and a comparison)."""
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    floored = [(a, kw) for a, kw in calls if kw.get("floor") is not None]
    check(floored, "K1: no floored call recorded")
    args, kwargs = floored[-1]
    got = RC.raster_blocks(*args, **kwargs)
    peeled = float((got[1] >= 0).double().mean())
    log(f"K1 with floor {tuple(got[1].shape)}, {args[0].shape[0]} chunks, "
        f"min_separation {kwargs.get('min_separation')}: second-layer "
        f"coverage {peeled:.4f}")
    return dict(raster_timing(args, kwargs, "floored (DepthPeeling)"),
                max_abs_err=0.0, mismatches=0, exact=True,
                timed_at=f"{tuple(got[1].shape)}", second_layer=peeled)


def compare_taps_same_class(calls, timed_label):
    """K6: bit-exact (a copy chosen by a table lookup) on every call kept
    from the configs' last frames; the row is timed at the largest call
    (timings)."""
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
    t = timings(f"K6 at {timed_label} {tuple(got.shape)}",
                lambda: F.fetch_taps_same_class(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_taps_same_class"], 50,
                plain=lambda: F.fetch_taps_same_class_plain(*args, **kwargs))
    # a copy per output; no single PyTorch call looks the offset up and
    # gathers (torch.gather needs the flat index this kernel computes): no
    # library yardstick
    return with_bound(
        dict(t, max_abs_err=0.0, mismatches=0, exact=True,
             timed_at=f"{timed_label} {tuple(got.shape)}"),
        nbytes(planes, lvl, tab, got), 0.0)


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
    t = timings(f"K9 {tuple(got.shape)}",
                lambda: RC.raster_stochastic_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["raster_stochastic"], 20,
                plain=lambda: RC.raster_stochastic_blocks_plain(
                    chunks, None, *args[2:]))
    pairs_walk = walk["visits"] * RC.TC * RC.RB
    n_bytes = nbytes(chunks, boxes, lists, counts, first, rmin, rmax, got)
    # no PyTorch call rasterizes triangles: no library yardstick
    return with_bound(
        dict(t, max_abs_err=0.0, mismatches=0, exact=True,
             parts=parts, walk=walk,
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
            log(f"{test} {name} on the card vs the committed golden: MSE "
                f"{mse:.4g} (bound 2e-4)")
            check(mse <= 2e-4, f"{test} {name}: MSE {mse} above 2e-4")


def run_configs():
    """Phases 11-14: configs 2 and 1 through the harness, their kernels
    against their plain versions and their rows; then the golden settings
    on the card. Returns (kernel rows, {label: launches})."""
    report = {}
    rows = []
    k6_calls = []
    for label in ("config2", "config1", "config1_suntemple"):
        kernels = kernels_of_configs()
        by_name = kernels_by_name(kernels)
        m, totals, modes = drive_config(label, kernels)
        check_config_calls(label, kernels)
        if label == "config2":
            rows.append(dict(compare_raster_stochastic(
                by_name["raster_stochastic"]),
                name="raster_stochastic", at=label,
                launches=totals["raster_stochastic"]))
        else:
            k6_calls += by_name["fetch_taps_same_class"].calls
        if label == "config1":
            k6_calls.append(dual_depth_frame(m, kernels))
        if label == "config1_suntemple":
            rows.append(dict(compare_raster_floor(by_name["raster"].calls),
                             name=FLOOR, at=label, launches=totals[FLOOR]))
            rows.append(dict(compare_taps_same_class(k6_calls, label),
                             name="fetch_taps_same_class", at=label,
                             launches=totals["fetch_taps_same_class"]))
        report[label] = dict(launches=totals, warp_launches_by_mode=modes)
        del m
    small_configs_against_references()
    for r in rows:
        r["config_launches"] = {lb: report[lb]["launches"].get(r["name"], 0)
                                for lb in report}
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
    """Chunks each K7 block visits, as float64: its world-box overlaps
    (the plain version's lists) on the SD grid's 8x32 tiles."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    tri, aabb, origin, rays = args[:4]
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
    every SD_SETTINGS entry on both tiers (sd_tiers_at). Returns the
    tiers' calls."""
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
    return sd_tiers_at(m._scene_comp, sd_ctx, sd_inputs, base)


def resident_row(tiers):
    """K7's kernel row from the default setting's call: bit-exact error,
    its times (timings), its chunk visits and its bound."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    _, args, kwargs, out = tiers["default"]["resident"]
    plain = RT.sd_trace_resident_blocks_plain(*args, **kwargs)
    err = _max_abs(RT.decode_packed(out, 0.0, 1.0),
                   RT.decode_packed(plain, 0.0, 1.0))
    visits = resident_visits(args)
    n_chunks = args[0].shape[0]
    walk = spread(visits)
    log(f"K7 sd_trace_resident {out.shape[0]} rays x {out.shape[1]} slots, "
        f"{n_chunks} chunks: visits per 8x32 tile {walk}")
    t = timings(f"K7 {out.shape[0]} rays",
                lambda: RT.sd_trace_resident_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["sd_trace_resident"], 10,
                plain=lambda: RT.sd_trace_resident_blocks_plain(
                    *args, **kwargs))
    return with_bound(
        dict(t, max_abs_err=err, mismatches=0, exact=True,
             timed_at=f"{tuple(out.shape)} rays x slots, {n_chunks} chunks",
             chunk_visits=int(visits.sum()), visits_per_block=walk),
        nbytes(args[:4], out),
        float(visits.sum()) * RT.TC * RT.RB * TRACE_FLOPS_PER_TEST)


def run_svao_full():
    """scripts/SVAO.py at Arcade@full 1280x720 through Renderer.renderFrame
    (the script's own properties): CONFIG_FRAMES frames with K7 once and
    K5 never per frame, the last frame's calls bit-exact against their
    plain versions (K1-K4, K7, K8, K10); svao_full_sd_phases; K7's row.
    Returns (K7's kernel row, {launches})."""
    label = "svao_full"
    kernels = kernels_of_configs()
    m, totals, modes = drive_config(label, kernels)
    check_config_calls(label, kernels)
    row = dict(resident_row(svao_full_sd_phases(m)),
               name="sd_trace_resident", at=label,
               launches=totals["sd_trace_resident"])
    del m
    return row, dict(launches=totals, warp_launches_by_mode=modes)


# ---------------------------------------------------------------------------
# BASELINE configs 3 and 4 (bench_configs.py:24-30) and SVAO's DualDepth and
# SingleDepth modes in scripts/SVAO.py
# ---------------------------------------------------------------------------

def sd_trace_timing(label, k) -> dict:
    """K5's row at the config's last call (held bit-exact by
    check_config_calls): its times (timings), its chunk visits per 8x32
    tile and its bound (the visits' ray-triangle tests)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    check(k.calls, f"{label}: no K5 call recorded")
    args, kwargs = k.calls[-1]
    out = RT.sd_trace_blocks(*args, **kwargs)
    n_chunks = args[0].shape[0]
    visits = walk_visits(*k5_lists(args), n_chunks)
    filled = float((out != RT.INVALID).any(1).double().mean())
    log(f"{label} K5: {out.shape[0]} rays ({out.shape[0] // RT.RB} tiles) x "
        f"{n_chunks} chunks, visits per tile {spread(visits)}; rays with a "
        f"hit {filled:.4f}")
    t = timings(f"{label} K5", lambda: RT.sd_trace_blocks(*args, **kwargs),
                KERNEL_SYMBOLS["sd_trace"], 10)
    return with_bound(
        dict(t, max_abs_err=0.0, rays=out.shape[0], chunks=n_chunks,
             chunk_visits=int(visits.sum()), visits_per_block=spread(visits),
             rays_with_a_hit=filled),
        nbytes(args[:4], args[9:11], out),
        float(visits.sum()) * RT.TC * RT.RB * TRACE_FLOPS_PER_TEST)


def k8_bound_at(label, k) -> dict:
    """K8's row at a config's last-frame call (held by check_config_calls):
    its times (timings) and its bound as compare_any_hit counts it (this
    run's pairs x the operations per pair of the warp that tests them,
    plus the boxes staged, from the replayed walk; its bytes)."""
    from rtsdm_tpu_torch.ops import rt_cuda as RT
    check(k.calls, f"{label}: no K8 call recorded")
    args, _ = k.calls[-1]
    tri, boxes, lists, counts, rays = args
    hit, pairs = RT.any_hit_blocks(*args)
    free = RT.no_cull_boxes(tri.shape[0], tri.device)
    _, pairs_f = RT.any_hit_blocks(tri, free, lists, counts, rays)
    walk = k8_walk(tri, boxes, lists, counts, rays, pairs_f)
    ops, p_h, p_m = any_hit_work(walk, pairs, rays)
    log(f"{label} K8: {int(rays.shape[1])} rays x {int(tri.shape[0])} "
        f"chunks, {float(pairs.double().sum()):.6g} pairs tested "
        f"({float(pairs_f.double().sum()):.6g} without the cull)")
    t = timings(f"{label} K8", lambda: RT.any_hit_blocks(*args),
                KERNEL_SYMBOLS["any_hit"], 10)
    return with_bound(
        dict(t, max_abs_err=0.0, rays=int(rays.shape[1]),
             chunks=int(tri.shape[0]), pairs=float(pairs.double().sum()),
             pairs_hoisted=p_h, pairs_per_pair_path=p_m,
             pairs_no_cull=float(pairs_f.double().sum()), walk=walk),
        nbytes(tri, boxes, lists, counts, rays, hit, pairs), ops)


def k11_timing(label, k):
    """K11's row at the last frame's first call (held bit-exact by
    check_config_calls): its times (timings) and its bound (each value
    written once, each SD texel the call reads read once: the plain
    version's fetch of a map of texel indices, exact in float32 below
    2^24 texels, counts them)."""
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    check(k.calls, f"{label}: K11 made no call")
    args, kwargs = k.calls[0]
    out = F.fetch_sd_strided(*args, **kwargs)
    sd_h, sd_w, depth_k = args[0].shape
    check(sd_h * sd_w < 2**24, f"{label}: K11's texel count is inexact")
    index = torch.arange(sd_h * sd_w, dtype=torch.float32,
                         device=out.device).reshape(sd_h, sd_w, 1)
    texels = int(F.fetch_sd_strided_plain(index, *args[1:], **kwargs)
                 .unique().numel())
    t = timings(f"{label} K11 {tuple(out.shape)}, {texels} SD texels read",
                lambda: F.fetch_sd_strided(*args, **kwargs),
                KERNEL_SYMBOLS["fetch_sd_strided"], 50,
                plain=lambda: F.fetch_sd_strided_plain(*args, **kwargs))
    return with_bound(dict(t, max_abs_err=0.0, shape=list(out.shape),
                           texels_read=texels),
                      nbytes(out) + texels * depth_k * 4, 0.0)


def k12_row(label, k):
    """K12's row at the last frame's first call (held bit-exact by
    check_config_calls): its times (timings; the plain version is the
    direction loop K12 replaced) and its bound: the setup planes it reads,
    K3's planes of the call's directions, the SD values, the stencil and
    delta (read where the call adds to one, written) each read or written
    once."""
    from rtsdm_tpu_torch.ops import resolve_cuda as RV
    from rtsdm_tpu_torch.passes import svao_shift
    from rtsdm_tpu_torch.utils.sampling import AO_KERNEL_VAO
    check(k.calls, f"{label}: K12 made no call")
    args, kwargs = k.calls[0]
    cfg, bq, _, radii, fetched, sd, stencil_q = args[:7]
    delta_in, d = (tuple(args[12:]) + (None, None))[:2]
    out = RV.svao_resolve(*args, **kwargs)
    read = RV.PLANES + (() if cfg.kernel == AO_KERNEL_VAO
                         else RV.HBAO_PLANES)
    planes = [bq[key] if comp is None else bq[key][comp]
              for _, key, comp in read]
    dirs = fetched if d is None else fetched[d]
    t = timings(f"{label} K12 {tuple(out.shape)}, "
                f"{len(radii) if d is None else 1} direction(s), SD values "
                f"{tuple(sd.shape)} {sd.dtype}",
                lambda: RV.svao_resolve(*args, **kwargs),
                KERNEL_SYMBOLS["svao_resolve"], 50,
                plain=lambda: svao_shift.svao_resolve_plain(*args, **kwargs))
    return with_bound(dict(t, max_abs_err=0.0, shape=list(out.shape),
                           directions=len(radii) if d is None else 1,
                           sd_shape=list(sd.shape)),
                      nbytes(planes, dirs, sd, stencil_q, delta_in, out),
                      0.0)


def h2d_copies_by_span(events) -> collections.Counter:
    """The host-to-device copies among a torch.profiler session's events
    (prof.events()), counted by the innermost program span ("rtsdm/" + its
    scope path, given without the prefix; "" for none) around the call
    that made each."""
    from rtsdm_tpu_torch.core.profiler import SPAN_PREFIX
    found = collections.Counter()
    for e in events:
        n = sum(1 for k in e.kernels if k.name.startswith("Memcpy HtoD"))
        if not n:
            continue
        p = e
        while p is not None and not p.name.startswith(SPAN_PREFIX):
            p = p.cpu_parent
        found[p.name[len(SPAN_PREFIX):] if p is not None else ""] += n
    return found


def frame_copies(m, label: str) -> dict:
    """One more frame of renderer m under torch.profiler, with its spans:
    the host-to-device copies it made by innermost span and the misses of
    its table caches (the tables.svao spans). SVAO's frame, its nested SD
    graph included, makes neither after its first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    m.profiler.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.renderFrame()
            torch.cuda.synchronize()
    finally:
        m.profiler.enabled = False
    events = prof.events()
    copies = h2d_copies_by_span(events)
    misses = sum(1 for e in events if e.name.endswith("/tables.svao"))
    log(f"{label}: a warm frame's host-to-device copies by innermost span "
        f"{dict(copies.most_common()) or 'none'}; tables.svao misses "
        f"{misses}")
    in_svao = sum(n for span, n in copies.items()
                  if span.startswith("renderFrame/SVAO"))
    check(in_svao == 0 and misses == 0,
          f"{label}: SVAO's warm frame made {in_svao} host-to-device "
          f"copies and {misses} table(s)")


def run_new_configs():
    """Phases 18-19: BASELINE config 4 (scripts/SVAO_quarter.py, Bistro@full
    1920x1080: quarter-res SVAO with dualAO, the SD trace streamed through
    K5, AOGuidedBlur) and config 3 (SVAO_small.py at stochMapDivisor 1 and
    SD guard band 512, SunTemple@full 1920x1080) through the harness:
    CONFIG_FRAMES frames with the launches of config_want, the last
    frame's calls bit-exact against their plain versions (K5 and K8 on a
    spread subset of tiles), K5's and K12's rows (and K8's at config 4,
    K11's at config 3), at config 3 a warm frame's host-to-device copies
    by span (none may lie in SVAO); then (phase 19b) config 2's raster SD
    map at config 3's frame (the benchmark's suntemple_1080p_rastersd.
    still): K9 once a frame on the unguarded 2048x1208 grid, K11 and K12 at
    guard 0 once a ring direction, held as config 3's, and K9's row
    (compare_raster_stochastic). Returns (kernel rows, {label:
    launches})."""
    report = {}
    rows = []
    for label in ("config4", "config3", "config2_suntemple"):
        kernels = kernels_of_configs()
        by_name = kernels_by_name(kernels)
        m, totals, modes = drive_config(label, kernels)
        if label == "config3":
            log("config3: phase 2 at divisor 1 reads the SD map through "
                "K11 (fetch_sd_strided), once a ring direction, where the "
                "JAX package runs XLA code (rtsdm_tpu/passes/"
                "svao_shift.py:578-580, no Pallas kernel): K4 serves "
                "divisor 4 only, so it never launches here")
        check_config_calls(label, kernels)
        if label == "config2_suntemple":
            k11 = by_name["fetch_sd_strided"].calls
            check(k11 and all(a[1] == 0 for a, _ in k11),
                  f"{label}: K11 not at guard 0: "
                  f"{sorted({a[1] for a, _ in k11})}")
            rows.append(dict(compare_raster_stochastic(
                by_name["raster_stochastic"]), name="raster_stochastic"))
        if label == "config3":
            rows.append(dict(k11_timing(label, by_name["fetch_sd_strided"]),
                             name="fetch_sd_strided"))
        if label != "config2_suntemple":
            rows.append(dict(k12_row(label, by_name["svao_resolve"]),
                             name="svao_resolve"))
            rows.append(dict(sd_trace_timing(label, by_name["sd_trace"]),
                             name="sd_trace"))
        if label == "config4":
            rows.append(dict(k8_bound_at(label, by_name["any_hit"]),
                             name="any_hit"))
        for r in rows:
            r.setdefault("at", label)
            r.setdefault("launches", totals.get(r["name"], 0))
        if label == "config3":
            frame_copies(m, label)
        report[label] = dict(launches=totals, warp_launches_by_mode=modes)
        del m
    return rows, report


def svao_modes_frames():
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
        log(f"SVAO.py with {props}: launches {counts}; AO in "
            f"[{lo:.4f}, {hi:.4f}]")
        check(all(counts[n] == v for n, v in want.items()),
              f"SVAO.py {mode}: launches {counts}, expected {want}")
        sets = [len(a[0]) for a, _ in by_name["fetch_all_directions"].calls]
        check(sets == ([2, 1] if dual else [1]),
              f"SVAO.py {mode}: K3 took {sets} plane sets")
        check_config_calls(f"SVAO.py {mode}", kernels)
        floored = sum(kw.get("floor") is not None
                      for _, kw in by_name["raster"].calls)
        check(floored == int(dual), f"{mode}: {floored} floored K1 calls held")
    log("SVAO.py DualDepth: K1 launched once with its floor and phase 1's "
        "K3 on 2 plane sets, both bit-exact with their plain versions; "
        "SingleDepth: no SD trace and no K4")
    del m


# ---------------------------------------------------------------------------
# scripts/SVAO_depth.py, SVAO's reference modes and RTAO (phases 21-22): the
# brute-force ray queries of ops/rt.py are plain PyTorch (XLA code in the
# JAX package)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def rt_queries():
    """While it holds, every call of ops/rt.py's closest_hit and
    vao_interval_query appends {fn, rays} to the yielded list."""
    from rtsdm_tpu_torch.ops import rt
    seen = []
    saved = []
    for name in ("closest_hit", "vao_interval_query"):
        real = getattr(rt, name)

        def recorded(scene, origins, *a, _real=real, _name=name, **kw):
            seen.append(dict(fn=_name, rays=int(origins.shape[0])))
            return _real(scene, origins, *a, **kw)

        saved.append((name, real))
        setattr(rt, name, recorded)
    try:
        yield seen
    finally:
        for name, real in saved:
            setattr(rt, name, real)


def run_svao_depth() -> dict:
    """Phase 21: scripts/SVAO_depth.py at Arcade@full 1280x720 through the
    harness, CONFIG_FRAMES frames on a paused clock (TemporalDepthPeel holds
    a layer from frame 1): SVAO under DualDepth with the SingleDepth
    secondary mode, SVAO_ref under Raytraced at full resolution. The
    launches of config_want per frame, counted between zeroing and reading
    around each frame; the last frame's calls held bit-exact against their
    plain versions (K1 with and without its floor, K2, K3, K10 bilinear);
    both outputs finite, of the requested size, AO in [0, 1]; one RT query
    a frame, tracing rays. Returns {launches}."""
    label = "svao_depth"
    kernels = kernels_of_configs()
    with rt_queries() as queries:
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
    check_config_calls(label, kernels)
    log(f"{label} SVAO_ref: {queries[-1]['fn']} traced "
        f"{queries[-1]['rays']} rays")
    check(queries[-1]["rays"] > 0, "svao_depth: SVAO_ref traced no ray")
    del m
    return dict(launches=totals, warp_launches_by_mode=modes)


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
    one RT query), set after the build; counts zeroed just before and read
    just after each frame, no plain version run, the frame's calls held
    bit-exact. Then one RTAO frame at that size (rtao_frame). Returns
    {mode: launches}."""
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
        with rt_queries() as queries, \
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
        log(f"SVAO.py with {props}: launches {counts}; AO in "
            f"[{lo:.4f}, {hi:.4f}]")
        check(all(counts[n] == v for n, v in want.items()),
              f"SVAO.py {mode}: launches {counts}, expected {want}")
        if mode == "HBAO":
            tables = [tuple(a[5]) for a, _ in by_name["fetch_all_directions"]
                      .calls] + [tuple(a[5]) for a, _ in
                                 by_name["fetch_sd_packed"].calls]
            check(len(tables) == 3 and all(t == hbao_radii for t in tables),
                  f"SVAO.py HBAO: K3/K4 took ring radii {tables}, not "
                  f"HBAO's {hbao_radii}")
        check_config_calls(f"SVAO.py {mode}", kernels)
        if mode == "Raytraced":
            check(len(queries) == 1, f"Raytraced: {len(queries)} queries")
            log(f"SVAO.py Raytraced: {queries[0]['fn']} traced "
                f"{queries[0]['rays']} rays")
        else:
            check(not queries, f"SVAO.py {mode}: an RT query ran")
        res[mode] = dict(launches=counts, warp_launches_by_mode=by_mode)
    del m
    rtao_frame()
    return res


def rtao_frame(scene_name="Arcade@full", width=1280, height=720):
    """One RTAO frame on the G-buffer of `scene_name` at width x height:
    a cosine ray a pixel through closest_hit, ambient finite and in
    [0, 1], some pixels occluded."""
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
    out, _ = p.execute(ctx, inputs)
    amb = out["ambient"]
    check(tuple(amb.shape) == (height, width)
          and bool(torch.isfinite(amb).all())
          and 0.0 <= float(amb.min()) and float(amb.max()) <= 1.0,
          "RTAO: ambient not finite in [0, 1]")
    occluded = float((amb < 1.0).float().mean())
    check(0.0 < occluded < 1.0, f"RTAO: occluded share {occluded}")
    log(f"RTAO frame, {scene_name} {width}x{height}: {occluded:.4f} of the "
        f"pixels occluded")


def maxcount_on_main_path(scene):
    """One SVAO-path frame at SunTemple@full with stochMaxCount 8: K5 (the
    streamed tier, 323,202 triangles) held bit-exact against its plain
    version with the cap."""
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
    _, args, _, out = calls[0]
    check(args[7] == 8, f"K5 took max_count {args[7]}")
    filled = float((out != RT.INVALID).sum(1).double().mean())
    log(f"SVAO path stochMaxCount 8: K5 bit-exact with its plain version; "
        f"{filled:.4f} filled slots per ray")


# ---------------------------------------------------------------------------
# the SD pass's inputs, the chunk visits of K5's and K7's walks, the
# parent's checkout
# ---------------------------------------------------------------------------

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


def spread(visits) -> dict:
    """Max, mean and tail of the chunk visits per block (float64 tensor)."""
    import torch
    v = visits.double().cpu()
    q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return dict(blocks=int(v.numel()), total=int(v.sum()),
                mean=float(v.mean()), p50=float(q[0]), p90=float(q[1]),
                p99=float(q[2]), max=int(v.max()))


def import_checkout(root: Path):
    """Import rtsdm_tpu_torch from the checkout at `root`."""
    sys.path.insert(0, str(root))
    import rtsdm_tpu_torch
    where = Path(rtsdm_tpu_torch.__file__).resolve().parent.parent
    check(where == root.resolve(), f"rtsdm_tpu_torch imported from {where}")


def child(flag: str, root: Path) -> dict:
    """The JSON a `chip_smoke.py FLAG ROOT` child process prints last."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag,
                          str(root)], capture_output=True, text=True,
                         timeout=900)
    check(out.returncode == 0, f"{flag} {root} failed:\n"
                               f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the mid-size comparison with the JAX package
# ---------------------------------------------------------------------------

# The mid-size references (tests/torch_refs/<name>.<scene>.<W>x<H>.f<frame>
# .npz) are the JAX package's renders of a graph script on the CPU, made by
# tests/torch_refs/make_refs.py, which records in each file's `settings`
# what it rendered: script, scene, size, frames, the frame kept, the
# outputs, the pass overrides and the JAX package's accelerator branches it
# took (its hazard notes say why). The port renders each with those
# settings; the port's rasters keep no per-tile cap, so a maxPerTile
# override changes nothing there.
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
MID_SVAO_FULL_BOUND = {"AmbientRef.out": 8e-6, "DiffuseRef.out": 6e-6,
                       "AmbientTAA.colorOut": 1e-5,
                       "DiffuseTAA.colorOut": 2e-6}
# Bounds fixed before the first chip run of these graphs: twice the MSE of
# the port's own CPU render against the reference, rounded up to one digit
# (SVAO_quarter.py: AO 3.245e-4, ShadedTAA 5.383e-6; SVAO.py under
# DualDepth: AmbientRef 3.173e-6). The quarter graph's AO is far from the
# reference because its inputs' differences (the rasters' last bits, the SD
# map's keys) reach the guided blur's bright/dark fusion, whose weights are
# ratios of small local deviations.
MID_QUARTER_BOUND = {"AmbientOcclusion.out": 7e-4, "ShadedTAA.colorOut": 2e-5}
MID_DUAL_BOUND = {"AmbientRef.out": 7e-6}
# Bounds fixed before its first chip run: twice the CPU port's MSE,
# rounded up (Ambient 1.836e-5, AmbientRef 1.887e-5)
MID_DEPTH_BOUND = {"Ambient.out": 4e-5, "AmbientRef.out": 4e-5}
# BASELINE config 5's animation (bench_configs.py:51-66), which phase 24
# sets on EmeraldSquare@full: the camera orbits (0, 2, 0) at radius 45 and
# height 14 in 8 s; the tallest 2% of the triangles by centroid height
# (node 1) oscillate 0.5 along y in 4 s; the clock plays. The SVAO_anim
# reference records the same animation on the small EmeraldSquare tier.
CONFIG5_ANIMATION = dict(
    camera_orbit=dict(center=[0.0, 2.0, 0.0], radius=45.0, height=14.0,
                      duration=8.0),
    node=1, tallest_share=50,
    node_track=dict(axis=[0.0, 1.0, 0.0], amplitude=0.5, period=4.0),
    clock="playing")
# Bounds: twice the card's MSE, rounded up to one digit (AO 2.074e-4, its
# TAA 8.923e-5, ShadedTAA 5.089e-6; the CPU port's to the last digit):
# raster edges of a far camera over small geometry, which its substituted
# hold removes
MID_ANIM_BOUND = {"AmbientOcclusion.out": 5e-4,
                  "AmbientOcclusionTAA.colorOut": 2e-4,
                  "ShadedTAA.colorOut": 2e-5}
# file name prefix -> MSE bounds
MID_REFS = {"SVAO_small": MID_MSE_BOUND, "HBAO": MID_HBAO_BOUND,
            "SVAO_rasterSD": MID_RASTER_SD_BOUND,
            "SVAO_full": MID_SVAO_FULL_BOUND,
            "SVAO_quarter": MID_QUARTER_BOUND, "SVAO_dual": MID_DUAL_BOUND,
            "SVAO_depth": MID_DEPTH_BOUND, "SVAO_anim": MID_ANIM_BOUND}
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
    """The reference make_refs.py wrote for `name`."""
    found = [p for p in (ROOT / "tests" / "torch_refs").glob(f"{name}.*.npz")
             if not p.name.endswith(".rasters.npz")]
    check(len(found) == 1, f"references of {name}: {found}")
    return found[0]


def mid_ref(name: str):
    """(settings, reference) of `name`: the settings make_refs.py recorded
    in the reference's file, checked against the file's name, and the
    file's arrays."""
    import numpy as np
    path = mid_ref_file(name)
    ref = np.load(path)
    settings = json.loads(str(ref["settings"]))
    want = (f"{name}.{settings['scene'].replace('@', '_')}."
            f"{settings['width']}x{settings['height']}.f{settings['frame']}"
            ".npz")
    check(path.name == want, f"{path.name} records {settings}")
    return settings, ref


def mid_rasters(name: str, settings: dict) -> dict:
    """The JAX package's raster channels stored beside reference `name`
    ({"<Pass>.<channel>": array}, or {"f<frame>/<Pass>.<channel>": array}
    where it renders more than one frame), checked to be the ones its
    settings list."""
    import numpy as np
    path = mid_ref_file(name).with_suffix(".rasters.npz")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
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
    """Phase 17: SVAO_small.py at its reference's settings through the
    port on the card, twice: pallasStream 'auto' (Arcade's 38,610
    triangles: the resident tier, K7) and True (the streamed tier, K5). Each marked output is held against
    the JAX package's render by MSE under its `bound` (None: measured
    only)."""
    settings, ref = mid_ref("SVAO_small")
    n = settings["frames"]
    res = {}
    for stream in ("auto", True):
        kept, launches = mid_frame(settings, stream)
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
    settings of their references through the port on the card, each
    marked output held against the JAX package's render by MSE under its
    bound (None: measured only)."""
    res = {}
    for name, bound, entry in (
            ("HBAO", bounds[0], "rtsdm_fetch_taps_same_class"),
            ("SVAO_rasterSD", bounds[1], "rtsdm_raster_stochastic")):
        settings, ref = mid_ref(name)
        kept, launches = mid_frame(settings)
        launches = {e: launches[e] for e in MID_ENTRIES}
        want = dict.fromkeys(MID_ENTRIES, 0)
        want[entry] = settings["frames"]
        check(launches == want, f"mid size {name}: launches {launches}, "
                                f"expected {want}")
        res.update(mid_rows(name, kept, ref, bound))
    return res


def mid_svao_full_against_jax(bound=MID_SVAO_FULL_BOUND) -> dict:
    """Phase 17c: scripts/SVAO.py at its reference's settings through the
    port on the card, each kept output held against the JAX package's
    render by MSE under its bound (None: measured only). Per frame K7 launches once (Arcade's 38,610 triangles)
    and K5, K6 and K9 never; K1 twice and never with its floor, K2 and K3
    twice, K4 once, K8 and TAA's two K10 calls."""
    from rtsdm_tpu_torch.ops import raster_cuda, warp_cuda
    settings, ref = mid_ref("SVAO_full")
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
    scripts/SVAO.py under DualDepth at their references' settings through
    the port on the card, each kept output held against the JAX package's
    render by MSE under its bound. Arcade's 38,610 triangles: K7 once a frame, K5, K6 and K9 never; under
    DualDepth DepthPeeling's K1 once a frame with its floor, none in the
    quarter graph. This checkout only: its parent cannot render them."""
    from rtsdm_tpu_torch.ops import raster_cuda
    res = {}
    for name, bound in (("SVAO_quarter", bounds[0]),
                        ("SVAO_dual", bounds[1])):
        settings, ref = mid_ref(name)
        n = settings["frames"]
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
    """Phase 17e: scripts/SVAO_depth.py at its reference's settings
    (frames 0 and 1: TemporalDepthPeel holds frame 0's layer in frame 1)
    through the port on the card, each output
    held against the JAX package's render by MSE under its bound; per
    frame DepthPeeling's floored K1 once, no SD trace, K6 or K9. Then the
    substituted holds of every reference but SVAO_anim's (phase 24b):
    rendered with the JAX package's raster channels (mid_rasters) in place
    of the port's, their AO outputs held under MID_SUBSTITUTED_BOUND. This
    checkout only."""
    from rtsdm_tpu_torch.ops import raster_cuda
    res = {}
    settings, ref = mid_ref("SVAO_depth")
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
        settings, ref = mid_ref(name)
        tiers = MID_SUBSTITUTED_TIERS.get(name, {"": None})
        for tier, stream in tiers.items():
            kept, _ = mid_frame(settings, stream,
                                substitute=mid_rasters(name, settings))
            kept = {k: v for k, v in kept.items() if k in sub_bound}
            label = f"{name}:substituted" + (f":{tier}" if tier else "")
            res.update(mid_rows(label, kept, ref, sub_bound))
    return res


# ---------------------------------------------------------------------------
# BASELINE config 5: scene animation, motion vectors from previous
# positions, and the sample patterns (phases 24-24c)
# ---------------------------------------------------------------------------

def k2_animated_row(k) -> dict:
    """K2's row at config 5's first call of the last frame, (nci, nflat) =
    K2_ANIMATED, which takes the kernel's run-time path (only K2_STATIC is
    a template): held and measured as compare_fetch_attributes does."""
    row = compare_fetch_attributes(k)
    (_, _, _, nci, nflat), _ = k.calls[0]
    check((nci, nflat) == K2_ANIMATED, f"K2 at {(nci, nflat)}")
    return dict(row, nci=nci, nflat=nflat)


def fetch_rows(by_name) -> dict:
    """K3's and K4's rows at the path's first recorded call (held bit-exact
    by check_config_calls): their times (timings) and bounds as
    compare_fetch_directions and compare_fetch_sd_packed count them."""
    import torch
    from rtsdm_tpu_torch.ops import fetch_cuda as F
    (sets, pad, radius, levels, offs, radii), kw = \
        by_name["fetch_all_directions"].calls[0]
    planes = torch.stack(list(sets)).contiguous()
    k3_args = (sets, pad, radius, levels, offs, radii)
    out = torch.stack(F.fetch_all_directions(*k3_args, **kw))
    t = timings(f"config5 K3 {tuple(out.shape)}",
                lambda: F.fetch_all_directions(*k3_args, **kw),
                KERNEL_SYMBOLS["fetch_all_directions"], 50,
                plain=lambda: F.fetch_all_directions_plain(
                    planes, pad, radius.contiguous(), levels, offs, radii))
    rows = {"fetch_all_directions": with_bound(
        dict(t, max_abs_err=0.0, timed_at=f"{tuple(out.shape)}"),
        nbytes(planes, radius, out), float(out.numel()))}
    k4_args, kw = by_name["fetch_sd_packed"].calls[0]
    sd_map, guard, radius, levels, offs, radii, _ = k4_args
    got = F.fetch_sd_packed(*k4_args, **kw)
    sd_pl = F.pack_sd16(sd_map)
    t = timings(f"config5 K4 {tuple(got.shape)}",
                lambda: F.fetch_sd_packed(*k4_args, **kw),
                KERNEL_SYMBOLS["fetch_sd_packed"], 50,
                plain=lambda: F.fetch_sd_packed_plain(
                    sd_pl, guard, radius.contiguous(), levels, offs, radii))
    rows["fetch_sd_packed"] = with_bound(
        dict(t, max_abs_err=0.0, timed_at=f"{tuple(got.shape)}"),
        nbytes(sd_map, radius, got), float(got.numel()))
    return rows


def node_motion(m):
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


def run_config5() -> tuple:
    """Phase 24: BASELINE config 5, scripts/SVAO_small.py on
    EmeraldSquare@full (1,036,922 triangles) at 1280x720 (1408x848 with
    the 64-pixel guard band), the camera orbiting and node 1 oscillating
    as bench_configs.py:51-66 sets them, the clock playing. Per frame the
    launches of config_want (K5 streams; K2 at K2_ANIMATED), K10 at least
    WARP_AT_LEAST; the outputs finite and AO in [0, 1]; the motion
    vectors' mean magnitude far above frame 0's (the camera moved), and
    the node's own motion (node_motion). The last frame's calls held
    bit-exact against their plain versions (K5 and K8 on spread tile
    subsets); the rows of K2-K5, K8, K10 and K12. Returns (kernel rows,
    {launches})."""
    label = "config5"
    kernels = kernels_of_configs()
    by_name = kernels_by_name(kernels)
    motion = []

    def per_frame(f, out):
        motion.append(float(out["GBufferRaster.mvec"].norm(dim=-1).mean()))

    m, totals, modes = drive_config(label, kernels, per_frame)
    log(f"config5 mean |mvec| per frame: {motion}")
    check(all(v > 100.0 * motion[0] for v in motion[1:]),
          "config5: the motion vectors do not show the camera's motion")
    check_config_calls(label, kernels)
    node_motion(m)
    rows = [dict(k2_animated_row(by_name["fetch_attributes"]),
                 name="fetch_attributes")]
    rows += [dict(r, name=n) for n, r in fetch_rows(by_name).items()]
    rows.append(dict(sd_trace_timing(label, by_name["sd_trace"]),
                     name="sd_trace"))
    rows.append(dict(k8_bound_at(label, by_name["any_hit"]), name="any_hit"))
    rows.append(dict(k12_row(label, by_name["svao_resolve"]),
                     name="svao_resolve"))
    rows += compare_warp(by_name["warp_resample"], modes)
    report = dict(launches=totals, warp_launches_by_mode=modes)
    for r in rows:
        r.update(at=label, launches=config_launches(report, r["name"]))
    del m
    return rows, report


def mid_anim_against_jax(bound=MID_ANIM_BOUND,
                         sub_bound=MID_SUBSTITUTED_BOUND["SVAO_anim"]):
    """Phase 24b: SVAO_anim (config 5's animation on EmeraldSquare's
    7,322 triangles, 480x270, frames 0-2, frame 2 kept) through the port
    on the card, held against the JAX package's render by MSE, then with
    the JAX package's per-frame G-buffer channels substituted (its AO
    outputs). Per frame K7 once, K5, K6 and K9 never, K2 twice."""
    settings, ref = mid_ref("SVAO_anim")
    kept, launches = mid_frame(settings)
    n = settings["frames"]
    got = {e: launches[e] for e in MID_ENTRIES + ("rtsdm_fetch_attributes",)}
    want = dict({e: 0 for e in MID_ENTRIES}, rtsdm_sd_trace_resident=n,
                rtsdm_fetch_attributes=2 * n)
    check(got == want, f"mid size SVAO_anim: launches {got}, expected "
                       f"{want}")
    res = mid_rows("SVAO_anim", kept, ref, bound)
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

EYE_CULL_CELLS = ("emerald_720p.orbit", "bistro_1080p.flyby")
EYE_CULL_SEED = 1


@contextlib.contextmanager
def recorded_rasters(calls: list, strict: list):
    """Every rasterize call of the port's rasters (GBufferRaster,
    ForwardLighting's G-buffer, DepthPass, DepthPeeling) appended to
    `calls` as a dict of its arguments, its outputs and its binning's
    returned tensors; while strict[0] is set, each binning runs after a
    synchronize under torch.cuda.set_sync_debug_mode("error")."""
    import torch
    from rtsdm_tpu_torch.ops import raster as R
    from rtsdm_tpu_torch.passes import depth_chain, gbuffer
    orig, orig_bins = R.rasterize, R._binned_chunks

    def bins(*a):
        if not strict[0]:
            return orig_bins(*a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig_bins(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def rasterize(view_proj, positions, **kw):
        got = []

        def kept(*a):
            got.append(bins(*a))
            return got[-1]

        R._binned_chunks = kept
        try:
            out = orig(view_proj, positions, **kw)
        finally:
            R._binned_chunks = orig_bins
        calls.append(dict(view_proj=view_proj, positions=positions, kw=kw,
                          out=out, bins=got[0]))
        return out

    mods = (gbuffer, depth_chain)
    for mod in mods:
        mod.rasterize = rasterize
    try:
        yield
    finally:
        for mod in mods:
            mod.rasterize = orig


def uncull_inputs(call):
    """K1's inputs of a recorded call binned as without the eye-plane cull
    (every valid triangle in screen-morton order, the chunks packed by
    _pack_bins), and its floor."""
    import torch
    from rtsdm_tpu_torch.ops import raster as R
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    from rtsdm_tpu_torch.ops.rt_cuda import pad_tile
    kw = call["kw"]
    w, h = kw["width"], kw["height"]
    coef, bbox, valid = R._setup_triangles(
        call["view_proj"], call["positions"], w, h, kw.get("jitter_x", 0.0),
        kw.get("jitter_y", 0.0), R.CULL_MODES[kw.get("cull", "back")])
    order = RC.screen_morton_order(bbox, valid, w, h)
    base = R._pack_bins(coef[order], bbox[order], valid[order], order,
                        -(-h // RC.TILE_RH), -(-w // RC.TILE_RW))
    floor = kw.get("depth_floor")
    if floor is not None:
        floor = pad_tile(floor.to(torch.float32), 3e38)[0].contiguous()
    return base, dict(floor=floor,
                      min_separation=kw.get("min_separation", 0.0))


def eye_cull_call(call, compared: bool) -> dict:
    """One recorded raster call against K1 on the binning without the cull:
    bit-equal outputs, the count culled, the mean chunk visits a tile with
    and without the cull; `compared` (the compared frame): the count
    computed again on the CPU."""
    import torch
    from rtsdm_tpu_torch.ops import raster as R
    from rtsdm_tpu_torch.ops import raster_cuda as RC
    bins, culled = call["bins"]
    out, kw = call["out"], call["kw"]
    base, fkw = uncull_inputs(call)
    z, tid, b1, b2 = RC.raster_blocks(*base, **fkw)
    crop = (slice(0, kw["height"]), slice(0, kw["width"]))
    same = (torch.equal(out["tri_id"], tid[crop])
            and torch.equal(out["depth"], z[crop])
            and torch.equal(out["bary"], torch.stack([b1[crop], b2[crop]],
                                                     -1)))
    row = dict(floored=fkw["floor"] is not None,
               eye_culled=int(out["eye_culled"]), same=bool(same),
               visits_mean=float(walk_visits(bins[2], bins[3],
                                             bins[0].shape[0]).mean()),
               visits_max=int(walk_visits(bins[2], bins[3],
                                          bins[0].shape[0]).max()),
               uncull_visits_mean=float(walk_visits(
                   base[2], base[3], base[0].shape[0]).mean()))
    check(row["eye_culled"] == int(culled), "eye_culled is not the count "
                                            "of the binning's cull")
    if compared:
        def cpu(v):
            return v.cpu() if isinstance(v, torch.Tensor) else v

        coef, _, valid, w = R._setup_with_w(
            cpu(call["view_proj"]), cpu(call["positions"]), kw["width"],
            kw["height"], cpu(kw.get("jitter_x", 0.0)),
            cpu(kw.get("jitter_y", 0.0)), R.CULL_MODES[kw.get("cull", "back")])
        wp = bins[5] * RC.TILE_RW
        hp = bins[4] * RC.TILE_RH
        row["eye_culled_cpu"] = int((valid & RC.behind_eye(coef, w, wp, hp))
                                    .sum())
    return row


def eye_cull_loops(seed: int = EYE_CULL_SEED) -> dict:
    """Phase 25 (module docstring) for each of EYE_CULL_CELLS."""
    import torch
    sys.path.insert(0, str(ROOT / "benchmark"))
    from harness import cell, discover
    from harness.drive import Driver
    report = {}
    for name in EYE_CULL_CELLS:
        wl = discover.load_json("workloads", name, discover.HERE)
        cfg = discover.load_json("configs", wl["config"], discover.HERE)
        arrays, camera = cell.inputs(cfg, wl, seed)
        drv = Driver("rtsdm_tpu_torch")
        m = drv.build(cfg, wl, arrays, camera, cfg["script"], "cuda")
        j_star = cell.compare_frames(seed, wl)
        loop = int(wl["loop_frames"])
        frames = []
        for f in range(loop):
            calls, strict = [], [f == j_star]
            with recorded_rasters(calls, strict):
                drv.render(m, f)
            torch.cuda.synchronize()
            check(calls, f"{name} frame {f}: no raster call recorded")
            frames.append([eye_cull_call(c, f == j_star) for c in calls])
            del calls
        rows = [r for fr in frames for r in fr]
        at = frames[j_star]
        report[name] = dict(seed=seed, compared_frame=j_star,
                            calls=len(rows), compared=at,
                            per_frame=[[r["eye_culled"], r["visits_mean"],
                                        r["uncull_visits_mean"]]
                                       for r in (fr[0] for fr in frames)])
        for r in at:
            log(f"eye cull, {name} seed {seed} frame {j_star}"
                f"{' (floored)' if r['floored'] else ''}: "
                f"{r['eye_culled']} triangles culled (CPU "
                f"{r['eye_culled_cpu']}); a tile visits "
                f"{r['visits_mean']:.2f} chunks (max {r['visits_max']}), "
                f"{r['uncull_visits_mean']:.2f} without the cull")
        log(f"eye cull, {name}: {len(rows)} K1 calls over {loop} frames; "
            "culled / visits / visits without, per frame (first call): "
            + "; ".join(f"{f}: {a} / {b:.1f} / {c:.1f}"
                        for f, (a, b, c) in enumerate(
                            report[name]["per_frame"])))
        moved = [f for f, fr in enumerate(frames)
                 if not all(r["same"] for r in fr)]
        check(not moved, f"{name}: K1's outputs moved with the eye-plane "
                         f"cull at frames {moved}")
        check(all(r["eye_culled"] == r["eye_culled_cpu"] for r in at),
              f"{name}: the card's eye_culled differs from the CPU's")
        log(f"eye cull, {name}: every K1 call bit-equal with and without "
            "the cull; the compared frame's counts equal the CPU's")
        del m, drv
        torch.cuda.empty_cache()
    return report


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Card check of the port on "
                                             "one NVIDIA GPU")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout of the parent commit: render "
                         "the mid-size phases through its package too and "
                         "fail if an MSE moved")
    ap.add_argument("--mid-child", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--eye-cull", type=int, default=None, metavar="SEED",
                    help="run phase 25 alone, for the benchmark seed SEED")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.mid_child is not None:
        print(json.dumps(mid_child(args.mid_child)), flush=True)
        return 0
    load_port()
    if args.eye_cull is not None:
        log(gpu_identity())
        print(json.dumps({"eye_cull": eye_cull_loops(args.eye_cull)}),
              flush=True)
        return 0
    from rtsdm_tpu_torch import _build
    from rtsdm_tpu_torch.scene.procedural import sun_temple

    kind = torch.cuda.get_device_name(0)
    log(gpu_identity())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    _build.kernel_library()
    _build.scenekit_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS['kernels']:.2f} s, g++ "
        f"{_build.BUILD_SECONDS['scenekit']:.2f} s)")

    scene = sun_temple(aspect=WIDTH / HEIGHT, detail="full", device="cuda")
    log(f"scene: SunTemple@full, {scene.num_triangles} triangles")

    # the SVAO path (phases 4-5)
    kernels = kernels_of_path()
    counts = drive_main_path(scene, kernels)
    rows = [dict(COMPARE[k.name](k), name=k.name, at="svao_path",
                 launches=counts[k.name]) for k in kernels]
    maxcount_on_main_path(scene)
    small_frame_against_cpu()

    # the graph path (phases 8-9)
    graph_kernels = kernels_of_graph()
    graph_counts, warp_modes = drive_graph(graph_kernels, counts)
    by_name = kernels_by_name(graph_kernels)
    hold_svao_resolve(by_name["svao_resolve"], "graph's last frame")
    rows.append(dict(compare_any_hit(by_name["any_hit"]), name="any_hit",
                     launches=graph_counts["any_hit"]))
    rows += compare_warp(by_name["warp_resample"], warp_modes)
    graph = dict(launches=graph_counts, warp_launches_by_mode=warp_modes)
    for r in rows:
        r.setdefault("at", "graph")
        r["graph_launches"] = config_launches(graph, r["name"])

    # BASELINE configs 2 and 1 (phases 11-14), SVAO.py (15)
    config_rows, configs = run_configs()
    k7_row, configs["svao_full"] = run_svao_full()
    rows += config_rows + [k7_row]
    # BASELINE configs 4 and 3 (phases 18-19), config 2 at config 3's
    # frame (19b), SVAO's depth modes (20)
    new_rows, new_configs = run_new_configs()
    rows += new_rows
    configs.update(new_configs)
    svao_modes_frames()
    # scripts/SVAO_depth.py (21), SVAO's reference modes and RTAO (22)
    configs["svao_depth"] = run_svao_depth()
    reference_modes = svao_reference_modes()
    # the mid-size phases against the JAX package (17-17e), through the
    # parent's kernels too with --parent (17-17c: the graphs it renders)
    parent_mid = None
    if args.parent is not None:
        parent_mid = child("--mid-child", args.parent.resolve())
        log("mid size through the parent's kernels: " + ", ".join(
            f"{k} MSE {v['mse']:.4g}" for k, v in parent_mid.items()))
        log("phases 17d and 18-20 run on this checkout only: the parent "
            "has no DownsamplePass, AOGuidedBlur or SVAO depth modes")
    mid_size = dict(mid_size_against_jax(), **mid_configs_against_jax(),
                    **mid_svao_full_against_jax(),
                    **mid_new_graphs_against_jax())
    mid_size.update(mid_svao_depth_against_jax())
    if parent_mid is not None:
        # every kernel is bit-exact with its plain version on both sides,
        # so the parent's MSEs are this checkout's to the last digit
        moved = {k: (v["mse"], mid_size[k]["mse"])
                 for k, v in parent_mid.items()
                 if f"{v['mse']:.4g}" != f"{mid_size[k]['mse']:.4g}"}
        check(not moved, f"mid size: MSEs moved from the parent's: {moved}")
    # BASELINE config 5 (24), its animation at mid size (24b), the golden
    # of the sample patterns (24c), K1's eye-plane cull (25)
    config5_rows, configs["config5"] = run_config5()
    rows += config5_rows
    mid_anim_against_jax()
    multisampling_golden()
    eye_cull_loops()

    src = kernels_by_name(kernels_of_configs())
    for r in rows:
        k = src[r["name"].split(":")[0]]
        r.update(source=k.source, replaces=k.replaces)
        r["launches_per_frame"] = {
            lb: config_launches(configs[lb], r["name"]) / CONFIG_FRAMES
            for lb in ("config3", "config4", "svao_depth", "config5",
                       "config2_suntemple")}
        r["launches_per_frame"].update({
            f"svao_full_{md}": config_launches(reference_modes[md],
                                               r["name"])
            for md, _, _ in REFERENCE_MODES})
        log(f"  {r['name']} at {r['at']}: kernel {r['ms']:.4f} ms, device "
            f"{ms_text(r['device_ms'])}, plain {ms_text(r['plain_ms'])}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            + ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
            + f"; launches {r['launches']}")
    keys = ("name", "at", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
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
