"""The device trace of a few frames: torch.profiler's CUDA activities
(kernels, copies, fills) between the host-clock marks of the frames, read
from its Chrome trace. Frame marks are record_function scopes named
FRAME_MARK around Renderer.renderFrame, which ends in a synchronize, so a
frame's device work lies inside its mark."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

from . import stats

FRAME_MARK = "benchmark.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Profiled:
    """Starts torch.profiler on enter and keeps the parsed trace on exit."""

    def __init__(self):
        self.summary = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def frame(self):
        from torch.profiler import record_function
        return record_function(FRAME_MARK)

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.summary = summarize(json.load(f))
        self._prof = None
        return False


def summarize(trace: dict) -> dict:
    """What the per-layer readers read from a Chrome trace: the frames'
    host intervals, the device activities inside them, their busy union,
    and the longest idle gaps named by the innermost host event that
    covers each gap's middle. Times in seconds."""
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    frames, device, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"]) * 1e-6
        iv = (s, s + float(e.get("dur", 0.0)) * 1e-6)
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name") == FRAME_MARK:
            frames.append(iv)
        if cat in DEVICE_CATS:
            device.append((iv, e.get("name", cat)))
        elif cat in HOST_CATS:
            host.append((iv, e.get("name", cat)))
    frames.sort()
    if not frames:
        return {"frames": 0}
    lo, hi = frames[0][0], frames[-1][1]
    inside = [(iv, n) for iv, n in device if iv[0] >= lo and iv[1] <= hi]
    ivs = [iv for iv, _ in inside]
    busy = stats.union_length(ivs, lo, hi)
    by_name = defaultdict(float)
    for (s, e), n in inside:
        by_name[n] += e - s
    idle = []
    for gs, ge in stats.gaps(ivs, lo, hi)[:10]:
        mid = 0.5 * (gs + ge)
        cover = [(e - s, n) for (s, e), n in host if s <= mid <= e]
        name = min(cover)[1] if cover else "host (no event)"
        idle.append([name, ge - gs])
    return {"frames": len(frames), "window_s": hi - lo, "busy_s": busy,
            "activities": len(inside),
            "kernel_s": dict(by_name),
            "device_ops": sorted(([n, t] for n, t in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": idle}


def kernel_seconds(summary: dict, needle: str) -> float | None:
    """Device seconds of the kernels whose name contains `needle`, or None
    when the trace has none."""
    found = [t for n, t in summary.get("kernel_s", {}).items() if needle in n]
    return sum(found) if found else None
