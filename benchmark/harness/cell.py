"""One run of one cell: set-up, the measured window, the reference, the
comparison and the readings the metric readers take their numbers from.

The window renders the cell's path (frames 0 .. loop_frames - 1, again
from 0 at the wrap) through Renderer.renderFrame for `seconds` seconds,
each frame timed by the host clock around the call (it ends in a
synchronize). One frame of the window, drawn from the seed among
compare_frames, is kept with the temporal passes' state the program held
before it and before the frame ahead of it. After the window the reference
renders, from the same inputs, that frame from that state, the frame ahead
of it from the state before (its new state against the program's: the
history stage), and set-up's first frame from a fresh state (the start);
each marked output and history is compared by its mean squared
difference."""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from . import guard, stats
from .discover import load_json
from .drive import Driver
from .scenegen import make_inputs
from .trace import Profiled

PROGRAM = guard.PROGRAM
REFERENCE = "reference.port"


def inputs(cfg: dict, wl: dict, seed: int):
    anim = wl.get("animation") or {}
    return make_inputs(cfg["scene"], seed, cfg["width"] / cfg["height"],
                       anim.get("tallest_share"))


def _clone_outputs(out: dict) -> dict:
    return {k: v.clone() for k, v in out.items()}


def _temporal_state(m) -> dict:
    """The temporal passes' state the renderer holds (each pass's dict of
    history tensors), copied."""
    state = getattr(m, "_state", None) or {}
    return {name: {k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in s.items()}
            for name, s in state.items() if isinstance(s, dict)}


def _scope_ms(m, name: str = "renderFrame") -> float:
    """Total host ms of the renderer profiler's top-level scope `name`."""
    for c in m.profiler.capture()["children"]:
        if c["name"] == name:
            return c["total_ms"]
    return 0.0


def compare_frames(seed: int, wl: dict) -> int:
    """The window's frame that is compared, drawn from the seed."""
    lo, hi = wl["compare_frames"]
    return int(np.random.default_rng(seed).integers(lo, hi))


def run_program(cfg: dict, wl: dict, arrays, camera, seed: int,
                seconds: float, trace: bool, device: str, t_process: float,
                keep_prev: bool = False):
    """Set-up and window of the program. Returns (readings, kept): kept
    holds the outputs of set-up's first frame and of the compared frame,
    with the compared frame's index on the path and the state before it
    (keep_prev: also the outputs of the frame before it)."""
    t_build = time.perf_counter()
    drv = Driver(PROGRAM)
    m = drv.build(cfg, wl, arrays, camera, cfg["script"], device)
    t_warm = time.perf_counter()
    loop = int(wl["loop_frames"])
    j_star = compare_frames(seed, wl)
    kept = {"frame": j_star % loop}
    for f in range(int(wl["warm_frames"])):
        out = drv.render(m, f % loop)
        if f == 0:
            kept["start"] = _clone_outputs(out)
    if device == "cuda":
        torch.cuda.synchronize()
    # set-up's objects out of the collector's way: the window's collections
    # scan what the frames allocate, not the scene and the harness
    gc.collect()
    gc.freeze()
    t_first = time.perf_counter()
    setup_s = t_first - t_process
    n_trace = int(wl.get("trace_frames", 4)) if trace else 0
    if trace:
        m.profiler.enabled = True
        m.profiler.reset()
        m.active_graph.time_passes = device == "cuda"
    frame_ms, pass_ms, harness_ms = [], {}, []
    profiled = None
    last_needed = j_star + max(n_trace, 1) - 1
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    # the window: every frame started before `seconds` have passed; then
    # the frames still owed to the comparison and the trace, untimed
    while True:
        in_window = t_end - t0 < seconds
        if not in_window and i > last_needed:
            break
        if i == j_star - 1:
            kept["state_prev"] = _temporal_state(m)
        if i == j_star:
            kept["state"] = _temporal_state(m)
        if n_trace and i == j_star:
            profiled = Profiled().__enter__()
        scope0 = _scope_ms(m) if trace else 0.0
        ts = time.perf_counter()
        if profiled is not None:
            with profiled.frame():
                out = drv.render(m, i % loop)
        else:
            out = drv.render(m, i % loop)
        te = time.perf_counter()
        if in_window:
            t_end = te
            frame_ms.append((te - ts) * 1e3)
            if trace:
                harness_ms.append((te - ts) * 1e3 - (_scope_ms(m) - scope0))
            if trace and m.active_graph.time_passes:
                for name, ms in m.active_graph.pass_times_ms().items():
                    pass_ms.setdefault(name, []).append(ms)
        if i == j_star:
            kept["compared"] = _clone_outputs(out)
        if keep_prev and i == j_star - 1:
            kept["compared_prev"] = _clone_outputs(out)
        if profiled is not None and i == j_star + n_trace - 1:
            profiled.__exit__(None, None, None)
        i += 1
    found = guard.forbidden_loaded()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    readings = dict(
        setup_s=setup_s, window_s=t_end - t0, frame_ms=frame_ms,
        frames=len(frame_ms), pass_ms=pass_ms, harness_ms=harness_ms,
        setup_parts={"build_s": t_warm - t_build, "warm_s": t_first - t_warm},
        trace=profiled.summary if profiled is not None else None)
    if device == "cuda":
        readings["peak_bytes"] = torch.cuda.max_memory_allocated()
    gc.unfreeze()
    del m, out, drv
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return readings, kept


def reference_frame(cfg: dict, wl: dict, arrays, camera, frame: int,
                    state: dict | None, device: str, storage=None):
    """The reference's outputs of the path's frame `frame`, the temporal
    passes starting from `state` (None: a fresh history), the counts its
    raster and any-hit calls recorded, and the temporal state it leaves.
    `storage`: the control's render-target dtype (None: float32, as the
    configuration states)."""
    import importlib
    graph = importlib.import_module(f"{REFERENCE}.rendergraph.graph")
    rast = importlib.import_module(f"{REFERENCE}.ops.ref_raster")
    hit = importlib.import_module(f"{REFERENCE}.ops.ref_any_hit")
    drv = Driver(REFERENCE)
    m = drv.build(cfg, wl, arrays, camera, cfg["reference_script"], device)
    m._build_frame_fn()
    if state:
        m._state.update({k: dict(v) for k, v in state.items()})
    rast.record, hit.record = [], []
    graph.STORAGE_DTYPE = storage
    try:
        out = drv.render(m, frame)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = {"raster": rast.record, "any_hit": hit.record}
    finally:
        graph.STORAGE_DTYPE = None
        rast.record = hit.record = None
    after = _temporal_state(m)
    del m
    return out, counts, after


def compare(outputs: dict, reference: dict, names, prefix: str = "") -> dict:
    """{prefix + output: mean squared difference} over `names`."""
    return {prefix + n: stats.mse(outputs[n], reference[n]) if n in outputs
            else math.inf for n in names}


def state_tensors(state: dict) -> dict:
    """{"<pass>.<key>": tensor} of a temporal state."""
    return {f"{p}.{k}": v for p, s in state.items() for k, v in s.items()
            if isinstance(v, torch.Tensor)}


def reference_checks(cfg, wl, arrays, camera, kept, device, storage=None):
    """The reference's side of the three comparisons of a run: (outputs of
    the compared frame from the program's state before it, the temporal
    state it leaves after the frame before that one from the program's
    state before that, outputs of set-up's first frame from a fresh
    state), with the counts of the compared frame."""
    loop = int(wl["loop_frames"])
    _, _, state = reference_frame(cfg, wl, arrays, camera,
                                  (kept["frame"] - 1) % loop,
                                  kept["state_prev"], device, storage)
    ref, counts, _ = reference_frame(cfg, wl, arrays, camera, kept["frame"],
                                     kept["state"], device, storage)
    ref0, _, _ = reference_frame(cfg, wl, arrays, camera, 0, None, device,
                                 storage)
    return ref, state_tensors(state), ref0, counts


def numbers_of(outputs, state, start, ref, ref_state, ref0, names) -> dict:
    """Every compared number: the compared frame's marked outputs, the
    temporal state the frame before it left (its history stage) and set-up's
    first frame's outputs (its start), each against the reference's."""
    numbers = compare(outputs, ref, names, "mse.")
    numbers.update(compare(state, ref_state, sorted(ref_state), "mse.state."))
    numbers.update(compare(start, ref0, names, "mse.start."))
    return numbers


def check_reference(cfg, wl, arrays, camera, kept, device):
    """The compared numbers of one run, the reference's counts and its
    seconds."""
    t = time.perf_counter()
    ref, ref_state, ref0, counts = reference_checks(cfg, wl, arrays, camera,
                                                    kept, device)
    numbers = numbers_of(kept["compared"], state_tensors(kept["state"]),
                         kept["start"], ref, ref_state, ref0, wl["outputs"])
    return numbers, counts, time.perf_counter() - t


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number at or under its limit; a number
    without a limit fails."""
    checks = {n: {"value": v, "limit": limits.get(n)}
              for n, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out[0].rpartition(",") if out else ("", "", "")
    return {"name": name.strip(), "power_limit": limit.strip()}


def run(cell_name: str, bench: dict, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", root=None) -> dict:
    """One run of `cell_name`: the result line's object. `root`: the
    folder holding configs/, workloads/ and metrics/ (the benchmark's)."""
    from . import discover
    root = root or discover.HERE
    wentry = discover.cell(bench, cell_name)
    wl = load_json("workloads", cell_name, root)
    cfg = load_json("configs", wl["config"], root)
    t_inputs = time.perf_counter()
    arrays, camera = inputs(cfg, wl, seed)
    t_inputs_done = time.perf_counter()
    readings, kept = run_program(cfg, wl, arrays, camera, seed, seconds,
                                 trace, device, t_process)
    readings["setup_parts"].update(imports_s=t_inputs - t_process,
                                   inputs_s=t_inputs_done - t_inputs)
    numbers, counts, ref_s = check_reference(cfg, wl, arrays, camera, kept,
                                             device)
    correct, checks = judge(numbers, wl.get("limits", {}))
    readings.update(reference=counts, config=cfg, workload=wl)
    metrics = {}
    for entry in discover.cell_metrics(bench, cell_name, trace):
        value = discover.load_metric(entry["name"], root).read(readings)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    failed = sum(1 for c in checks.values()
                 if c["limit"] is None or not c["value"] <= c["limit"])
    result = {"correct": correct, "attempted": len(checks),
              "failed": failed, "metrics": metrics}
    result["device"] = device_info(readings, wentry, trace, device)
    if trace and readings.get("trace"):
        tr = readings["trace"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["frames"] = readings["frames"]
    result["setup_parts"] = readings["setup_parts"]
    result["reference_s"] = ref_s
    result["compared_frame"] = kept["frame"]
    if device == "cuda":
        result["card"] = card()
    result["checks"] = checks
    return result


def device_info(readings, wentry, trace: bool, device: str) -> dict:
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(wentry["chips"]),
                "memory_peak_bytes": int(readings["peak_bytes"])}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace and readings.get("trace") and readings["trace"].get("frames"):
        info["busy_s"] = readings["trace"]["busy_s"]
        info["window_s"] = readings["trace"]["window_s"]
    return info


def report_checks(checks: dict, out=sys.stderr) -> None:
    """The compared numbers beside their limits, one a line."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=out)
