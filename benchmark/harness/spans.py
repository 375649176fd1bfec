"""The program's own spans, read for per-layer metrics of a traced run.

rtsdm_tpu_torch's profiler (Renderer.profiler, on in a traced run) keeps
a tree of scopes with host-clock totals (its capture), and opens each
scope as a torch.profiler record_function named SPAN_PREFIX + the scope's
path ("rtsdm/renderFrame/SVAO/phase1"), so the spans lie in the device
trace's Chrome trace on the device's clock. From the capture come the
host ms of the spans per window frame; from the Chrome trace the device's
idle time and activities put down to the spans the host was in. A program
without these spans gives no number (None), never an error.

The two inputs are the capture after the window and the traced frames'
Chrome trace; benchmark/span_report.py collects both from one traced run.
Times from the capture are ms, those of the attribution seconds, as in
trace.summarize.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from . import stats
from .trace import DEVICE_CATS, FRAME_MARK

SPAN_PREFIX = "rtsdm/"
# host events that launch device work; a device activity names its launch
# by args.correlation
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SVAO_PHASES = ("phase1", "sd_map", "phase2")
IDLE_PASSES = ("GBufferRaster", "SVAO")


# ---------------------------------------------------------------------------
# the capture: host ms per window frame
# ---------------------------------------------------------------------------

def node(capture: dict, path: str) -> dict | None:
    """The capture's node at scope path `path` ("renderFrame/SVAO")."""
    cur = capture
    for name in path.split("/"):
        cur = next((c for c in cur.get("children", ())
                    if c["name"] == name), None)
        if cur is None:
            return None
    return cur


def frames(capture: dict) -> int:
    """Frames the capture holds: its renderFrame scope's count."""
    n = node(capture, "renderFrame")
    return n["count"] if n else 0


def outermost(capture: dict, prefix: str) -> list[dict]:
    """Every node whose name starts with `prefix` and that lies under no
    other such node."""
    found, stack = [], list(capture.get("children", ()))
    while stack:
        c = stack.pop()
        if c["name"].startswith(prefix):
            found.append(c)
        else:
            stack.extend(c.get("children", ()))
    return found


def _per_frame(capture: dict, nodes) -> float | None:
    nodes = [n for n in nodes if n is not None]
    n_frames = frames(capture)
    if not nodes or not n_frames:
        return None
    return sum(n["total_ms"] for n in nodes) / n_frames


def span_metrics(capture: dict | None) -> dict:
    """The program_span metrics {name: ms per window frame}; one whose
    spans the program lacks is left out."""
    if not capture:
        return {}
    out = {"span_ms.harness": _per_frame(
        capture, [node(capture, "animate"), node(capture, "camera_path")])}
    for phase in SVAO_PHASES:
        out[f"span_ms.SVAO.{phase}"] = _per_frame(
            capture, [node(capture, f"renderFrame/SVAO/{phase}")])
    out["span_ms.geometry"] = _per_frame(
        capture, outermost(capture, "geometry."))
    out["span_ms.wrappers"] = _per_frame(
        capture, outermost(capture, "kernel."))
    return {k: v for k, v in out.items() if v is not None}


def _flat(capture: dict) -> dict:
    """{scope path: (count, total_ms)} of a capture."""
    out, stack = {}, [(c, c["name"]) for c in capture.get("children", ())]
    while stack:
        c, path = stack.pop()
        out[path] = (c["count"], c["total_ms"])
        stack.extend((k, f"{path}/{k['name']}") for k in c["children"])
    return out


def less(capture: dict, after: dict, before: dict) -> dict:
    """`capture` less what each of its scopes gained from the capture
    `before` to the capture `after`: the window without the frames
    torch.profiler traced, whose host time the profiler multiplies."""
    fa, fb = _flat(after), _flat(before)

    def walk(n, path):
        ca, ta = fa.get(path, (0, 0.0))
        cb, tb = fb.get(path, (0, 0.0))
        kids = [walk(c, f"{path}/{c['name']}" if path else c["name"])
                for c in n.get("children", ())]
        return dict(n, count=n["count"] - (ca - cb),
                    total_ms=n["total_ms"] - (ta - tb), children=kids)

    return walk(capture, "")


def per_frame_ms(capture: dict) -> dict:
    """{scope path: host ms per window frame} of every scope."""
    n_frames = frames(capture)
    return {path: total / n_frames for path, (_, total) in
            sorted(_flat(capture).items())} if n_frames else {}


def spans_per_frame(capture: dict) -> float | None:
    """Scopes opened per window frame, every kind counted."""
    n_frames = frames(capture)
    if not n_frames:
        return None
    total, stack = 0, list(capture.get("children", ()))
    while stack:
        c = stack.pop()
        total += c["count"]
        stack.extend(c.get("children", ()))
    return total / n_frames


# ---------------------------------------------------------------------------
# the Chrome trace: device idle and activities by program span
# ---------------------------------------------------------------------------

def _innermost(spans):
    """Properly nested spans [(start, end, name)] -> disjoint segments
    [(start, end, name)], each named by the innermost span over it."""
    out, stack, t = [], [], None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            if end > t:
                out.append((t, end, nm))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        t = s
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        end, nm = stack.pop()
        if end > t:
            out.append((t, end, nm))
            t = end
    return out


def _overlaps(xs, ys):
    """Pieces (start, end, i, j) where interval xs[i] meets ys[j]; both
    lists sorted and disjoint within themselves."""
    i = j = 0
    while i < len(xs) and j < len(ys):
        s = max(xs[i][0], ys[j][0])
        e = min(xs[i][1], ys[j][1])
        if e > s:
            yield s, e, i, j
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1


class _Sums:
    """Sums over sorted disjoint intervals inside a query interval."""

    def __init__(self, ivs):
        self.starts = [s for s, _ in ivs]
        self.ends = [e for _, e in ivs]
        self.cum = [0.0]
        for s, e in ivs:
            self.cum.append(self.cum[-1] + e - s)

    def within(self, s: float, e: float) -> float:
        i = bisect.bisect_right(self.ends, s)
        j = bisect.bisect_left(self.starts, e)
        if i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, s - self.starts[i])
                - max(0.0, self.ends[j - 1] - e))


def attribute(trace) -> dict:
    """The traced frames' device idle time and activities put down to the
    program's spans (seconds): idle is the complement of the union of the
    device activities inside the frame marks; `idle_by_span` splits it by
    the innermost span the host was in, and `no_span_s` is the rest;
    `span_idle_s` is the idle time that overlaps each span path's host
    intervals, its inner spans' included; `span_activities` counts the
    activities whose launch (matched by args.correlation) lies inside
    them; `device_by_span` sums device time by the innermost span at each
    activity's launch and its name. Span paths drop SPAN_PREFIX."""
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    marks, device, spans, launches = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"]) * 1e-6
        iv = (s, s + float(e.get("dur", 0.0)) * 1e-6)
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation":
            if name == FRAME_MARK:
                marks.append(iv)
            elif name.startswith(SPAN_PREFIX):
                spans.append((*iv, name[len(SPAN_PREFIX):]))
        elif cat in DEVICE_CATS:
            device.append((iv, (e.get("args") or {}).get("correlation"),
                           name or cat))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = s
    marks.sort()
    if not marks:
        return {"frames": 0}
    lo, hi = marks[0][0], marks[-1][1]
    inside = [d for d in device if d[0][0] >= lo and d[0][1] <= hi]
    gaps = sorted(stats.gaps([iv for iv, _, _ in inside], lo, hi))
    idle = [(s, e) for s, e, _, _ in _overlaps(gaps, marks)]
    segments = _innermost([sp for sp in spans if lo <= sp[0] <= hi])
    by_span = defaultdict(float)
    for s, e, _, j in _overlaps(idle, segments):
        by_span[segments[j][2]] += e - s
    idle_s = sum(e - s for s, e in idle)
    sums = _Sums(idle)
    launched = sorted(launches[c] for _, c, _ in inside if c in launches)
    span_idle, span_acts = defaultdict(float), defaultdict(int)
    for s, e, name in spans:
        span_idle[name] += sums.within(s, e)
        span_acts[name] += (bisect.bisect_right(launched, e)
                            - bisect.bisect_left(launched, s))
    return {"frames": len(marks), "idle_s": idle_s,
            "idle_by_span": dict(by_span),
            "no_span_s": idle_s - sum(by_span.values()),
            "span_idle_s": dict(span_idle),
            "span_activities": dict(span_acts),
            "device_by_span": _device_by_span(inside, launches, segments),
            "activities": len(inside), "launched": len(launched)}


def _device_by_span(inside, launches, segments) -> dict:
    """{(innermost span at the launch, activity name): device seconds}."""
    starts = [s for s, _, _ in segments]
    out = defaultdict(float)
    for (s, e), corr, name in inside:
        t = launches.get(corr)
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        span = segments[k][2] if k >= 0 and t <= segments[k][1] else None
        out[(span, name)] += e - s
    return dict(out)


def trace_metrics(attribution: dict | None) -> dict:
    """The device_trace metrics of the program's spans, per traced frame:
    idle_ms.<pass> for GBufferRaster and SVAO, activities.SVAO; one whose
    span the trace lacks is left out."""
    if not attribution or not attribution.get("frames"):
        return {}
    n = attribution["frames"]
    idle, acts = attribution["span_idle_s"], attribution["span_activities"]
    out = {f"idle_ms.{p}": idle[f"renderFrame/{p}"] * 1e3 / n
           for p in IDLE_PASSES if f"renderFrame/{p}" in idle}
    if "renderFrame/SVAO" in acts:
        out["activities.SVAO"] = acts["renderFrame/SVAO"] / n
    return out


def device_by_span(attribution: dict | None, top: int = 20) -> list:
    """The largest device times, [span the host launched from, activity
    name, ms over the traced frames], longest first (span None: launched
    under no program span)."""
    if not attribution or not attribution.get("frames"):
        return []
    ranked = sorted(attribution["device_by_span"].items(),
                    key=lambda kv: -kv[1])[:top]
    return [[span, name, t * 1e3] for (span, name), t in ranked]


def idle_by_span(attribution: dict | None) -> dict | None:
    """The traced frames' idle ms by the innermost program span, longest
    first, with the idle under no program span apart (ms and % of the
    idle inside the frame marks)."""
    if not attribution or not attribution.get("frames"):
        return None
    idle_s = attribution["idle_s"]
    return {"frames": attribution["frames"], "idle_ms": idle_s * 1e3,
            "spans_ms": {k: v * 1e3 for k, v in sorted(
                attribution["idle_by_span"].items(), key=lambda kv: -kv[1])},
            "no_span_ms": attribution["no_span_s"] * 1e3,
            "no_span_pct": (100.0 * attribution["no_span_s"] / idle_s
                            if idle_s > 0 else 0.0)}
