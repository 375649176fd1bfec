"""A traced run of one benchmark cell, as `run.py --trace 1` makes it, that
also reads the program's own spans (harness/spans.py):

    python3 benchmark/span_report.py --workload bistro_1080p.flyby \
        --seed 7 --seconds 51

from the root of a checkout. It prints run.py's result line with four
keys added: `spans`, the span metrics (span_ms.* per window frame from
Renderer.profiler's capture; idle_ms.GBufferRaster, idle_ms.SVAO and
activities.SVAO per traced frame from the Chrome trace), `idle_by_span`,
the traced frames' idle ms by the innermost program span,
`device_by_span`, the largest device times by the span that launched
them, and `span_run`: the mean time of the window's frames, the spans
opened per frame, each span's host ms per frame and the share of the
SVAO span's host time in its three phases. The window's numbers leave
out the frames torch.profiler traced, whose host time the profiler
multiplies.

To collect the capture and the Chrome trace it wraps functions of the
harness for the run (Driver.build keeps the program's renderer,
Profiled's enter and exit take the capture around the traced frames,
trace.summarize reads the trace it is given, cell.run_program takes the
capture after the window) and leaves each reading of the run as it was.
"""
from __future__ import annotations

import contextlib
import gc
import sys

from harness import cell, drive, guard, spans, trace


def _capture(got):
    m = got.get("renderer")
    return m.profiler.capture() if m is not None else None


def _window(got, readings) -> tuple[dict | None, dict]:
    """The capture and the numbers of the window without the frames
    torch.profiler traced."""
    capture, before, after = (got.get(k) for k in ("capture", "before",
                                                   "after"))
    times = list(readings["frame_ms"])
    if capture and before and after:
        capture = spans.less(capture, after, before)
        first, last = spans.frames(before), spans.frames(after)
        times = times[:first] + times[last:]
    run = {"frame_ms": sum(times) / len(times) if times else None,
           "frames": len(times),
           "spans_per_frame": spans.spans_per_frame(capture)
           if capture else None,
           "span_ms": spans.per_frame_ms(capture) if capture else None}
    svao = spans.node(capture, "renderFrame/SVAO") if capture else None
    if svao and svao["total_ms"] > 0:
        phases = [spans.node(capture, f"renderFrame/SVAO/{p}")
                  for p in spans.SVAO_PHASES]
        run["svao_phase_share"] = sum(
            p["total_ms"] for p in phases if p) / svao["total_ms"]
    return capture, run


@contextlib.contextmanager
def reading_spans():
    """For the enclosed runs, cell.run's result also holds `spans`,
    `idle_by_span`, `device_by_span` and `span_run`."""
    got = {}
    build, summarize = drive.Driver.build, trace.summarize
    enter, leave = trace.Profiled.__enter__, trace.Profiled.__exit__
    run_program, run_cell = cell.run_program, cell.run

    def build_kept(self, *args, **kwargs):
        m = build(self, *args, **kwargs)
        if self.package == guard.PROGRAM:
            got["renderer"] = m
        return m

    def enter_read(self):
        got["before"] = _capture(got)
        return enter(self)

    def leave_read(self, *exc):
        out = leave(self, *exc)
        got["after"] = _capture(got)
        return out

    def summarize_read(tr):
        got["attribution"] = spans.attribute(tr)
        return summarize(tr)

    def run_program_read(*args, **kwargs):
        readings, kept = run_program(*args, **kwargs)
        got["capture"] = _capture(got)
        got.pop("renderer", None)
        gc.collect()
        got["window"] = _window(got, readings)
        return readings, kept

    def run_read(*args, **kwargs):
        got.clear()
        result = run_cell(*args, **kwargs)
        capture, window = got.get("window", (None, {}))
        attribution = got.get("attribution")
        result["spans"] = {**spans.span_metrics(capture),
                           **spans.trace_metrics(attribution)}
        result["idle_by_span"] = spans.idle_by_span(attribution)
        result["device_by_span"] = spans.device_by_span(attribution)
        result["span_run"] = window
        return result

    seams = ((drive.Driver, "build", build_kept),
             (trace.Profiled, "__enter__", enter_read),
             (trace.Profiled, "__exit__", leave_read),
             (trace, "summarize", summarize_read),
             (cell, "run_program", run_program_read),
             (cell, "run", run_read))
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in seams]
    for obj, name, fn in seams:
        setattr(obj, name, fn)
    try:
        yield got
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
        got.clear()


def main(argv=None) -> int:
    import run  # sets the process up as run.py does: one core, one thread
    argv = list(sys.argv[1:] if argv is None else argv)
    with reading_spans():
        return run.main([*argv, "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
