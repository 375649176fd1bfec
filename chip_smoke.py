#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (rtsdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. refuse to run without a CUDA device, or outside a checkout of the repo;
2. print the card's name and power limit (nvidia-smi);
3. build the CUDA kernels (csrc/*.cu, nvcc, sm_90a) and the scene helper;
4. drive the main path once, as bench.py does, at SunTemple@full 1920x1080:
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
   the AO with the bound those tests use.

The last three lines are JSON: the frame's times, one entry per kernel
({"kernels": [...]}), and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT = 1920, 1080
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
    """One CUDA kernel of the main path: its C entry point (whose launches
    the wrapper counts), its wrapper, the name the main path looks the
    wrapper up under, its plain version, and the TPU kernel it replaces."""

    def __init__(self, name, entry, wrapper, lookup, plain_owner,
                 plain_name, source, replaces):
        self.name, self.entry = name, entry
        self.wrapper, self.lookup = wrapper, lookup
        self.plain_owner, self.plain_name = plain_owner, plain_name
        self.source, self.replaces = source, replaces
        self.calls = []          # (args, kwargs) of the main path's calls
        self.result = {}

    @property
    def launches(self) -> int:
        """Launches of the kernel's C entry point, counted by the wrapper
        where it launches the kernel (rtsdm_tpu_torch._build.launch)."""
        from rtsdm_tpu_torch._build import LAUNCHES
        return LAUNCHES[self.entry]


def kernels_of_path():
    from rtsdm_tpu_torch.ops import fetch_cuda, raster_cuda, rt_cuda
    from rtsdm_tpu_torch.passes import svao_shift
    return [
        Kernel("raster", "rtsdm_raster_blocks",
               raster_cuda.raster_blocks,
               (raster_cuda, "raster_blocks"), raster_cuda,
               "raster_blocks_plain", "rtsdm_tpu_torch/csrc/raster.cu",
               "rtsdm_tpu/ops/raster_pallas.py:394"),
        Kernel("fetch_attributes", "rtsdm_fetch_attributes",
               raster_cuda.fetch_attributes,
               (raster_cuda, "fetch_attributes"), raster_cuda,
               "fetch_attributes_plain", "rtsdm_tpu_torch/csrc/raster.cu",
               "rtsdm_tpu/ops/raster_pallas.py:584"),
        Kernel("fetch_all_directions", "rtsdm_fetch_directions",
               fetch_cuda.fetch_all_directions,
               (svao_shift, "fetch_all_directions"), fetch_cuda,
               "fetch_all_directions_plain", "rtsdm_tpu_torch/csrc/fetch.cu",
               "rtsdm_tpu/ops/fetch_pallas.py:221"),
        Kernel("fetch_sd_packed", "rtsdm_fetch_sd_packed",
               fetch_cuda.fetch_sd_packed,
               (svao_shift, "fetch_sd_packed"), fetch_cuda,
               "fetch_sd_packed_plain", "rtsdm_tpu_torch/csrc/fetch.cu",
               "rtsdm_tpu/ops/fetch_pallas.py:432"),
        Kernel("sd_trace", "rtsdm_sd_trace",
               rt_cuda.sd_trace_blocks,
               (rt_cuda, "sd_trace_blocks"), rt_cuda,
               "sd_trace_blocks_plain", "rtsdm_tpu_torch/csrc/sd_trace.cu",
               "rtsdm_tpu/ops/rt_pallas.py:791"),
    ]


@contextlib.contextmanager
def record_main_path(kernels):
    """Keep the arguments of every kernel call the main path makes, and
    fail any call of a plain version while the main path runs."""
    saved = []
    plain_calls = []
    for k in kernels:
        owner, attr = k.lookup
        check(getattr(owner, attr) is k.wrapper,
              f"{k.name}: the main path does not look up its wrapper as "
              f"{owner.__name__}.{attr}")

        def rec(*args, _k=k, **kwargs):
            _k.calls.append((args, kwargs))
            return _k.wrapper(*args, **kwargs)

        def plain_guard(*args, _k=k, **kwargs):
            plain_calls.append(_k.name)
            raise SmokeFailure(f"{_k.name}: the plain version ran on the "
                               "main path")

        saved.append((owner, attr, getattr(owner, attr)))
        saved.append((k.plain_owner, k.plain_name,
                      getattr(k.plain_owner, k.plain_name)))
        setattr(owner, attr, rec)
        setattr(k.plain_owner, k.plain_name, plain_guard)
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


def chunk_visits(lists, counts, n_chunks: int) -> str:
    """The work of a tile walk: chunks visited per tile (a tile whose list
    overflowed visits every chunk)."""
    visits = counts.clamp(max=lists.shape[1]).where(
        counts <= lists.shape[1], n_chunks).double()
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
    return dict(max_abs_err=err, mismatches=mism, exact=exact,
                ms=cuda_ms(lambda: RC.raster_blocks(*args, **kwargs), 20, 2),
                plain_ms=cuda_ms(lambda: RC.raster_blocks_plain(*args,
                                                                **kwargs),
                                 1, 1))


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
    return dict(max_abs_err=err, mismatches=0, exact=True,
                ms=cuda_ms(lambda: RC.fetch_attributes(*args, **kwargs), 50,
                           3),
                plain_ms=cuda_ms(lambda: RC.fetch_attributes_plain(
                    *args, **kwargs), 10, 2))


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
    return dict(max_abs_err=err, mismatches=mism, exact=True,
                ms=cuda_ms(lambda: F.fetch_all_directions(*args, **kwargs),
                           50, 3),
                plain_ms=cuda_ms(plain, 5, 1))


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
    return dict(max_abs_err=err, mismatches=mism, exact=True,
                ms=cuda_ms(lambda: F.fetch_sd_packed(*args, **kwargs), 50, 3),
                plain_ms=cuda_ms(plain, 5, 1))


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
    return dict(max_abs_err=err, mismatches=mism,
                exact=bool(torch.equal(got, want)),
                ms=cuda_ms(lambda: RT.sd_trace_blocks(*args, **kwargs), 10,
                           2),
                plain_ms=cuda_ms(lambda: RT.sd_trace_blocks_plain(
                    *args, **kwargs), 1, 1))


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
                  "sd_trace": "sd_trace_kernel"}


def profiled_frame(scene, pass_, ctx):
    """Device activity of one steady-state frame under torch.profiler:
    {name: (ms, count)} over every kernel, copy and fill the card ran.
    Empty where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    frame(scene, pass_, ctx, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame(scene, pass_, ctx, WIDTH, HEIGHT)
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

    print(json.dumps({"frame": {
        "gpu": ident, "stages_ms": stages, "host_ms": host_ms,
        "device_busy_ms": busy_ms if acts else None,
        "kernel_device_ms": {k.name: kernel_device_ms(acts, k.name)
                             for k in kernels},
        "peak_device_gib": peak_gib}}))
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         "max_abs_err": k.result["max_abs_err"], "ms": k.result["ms"],
         "plain_ms": k.result["plain_ms"]} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
