"""Measurement passes (counterpart of rtsdm_tpu/passes/measure.py).
Ported so far: PathBenchmark and VideoRecorder, two side-effect passes
with no outputs, which the graph keeps live (RenderGraph.execute)."""
from __future__ import annotations

from ..rendergraph.render_pass import PassReflection, RenderPass, register_pass


@register_pass("PathBenchmark")
class PathBenchmark(RenderPass):
    """Records the profiler's per-scope averages every frame while the
    context's profiler is on; csv() exports them as the PathBenchmark table
    (PathBenchmark.cpp:59-90)."""

    SCHEMA = dict()

    def __init__(self, props=None):
        super().__init__(props)
        self.rows: list[dict] = []

    def reflect(self, ctx):
        return PassReflection()

    def execute(self, ctx, inputs, state=None):
        if ctx.profiler is not None and ctx.profiler.enabled:
            self.rows.append(dict(ctx.profiler.flat_averages()))
        return {}, None

    def csv(self) -> str:
        if not self.rows:
            return ""
        keys = sorted({k for r in self.rows for k in r})
        lines = [",".join(["frame"] + keys)]
        for i, r in enumerate(self.rows):
            lines.append(",".join([str(i)] + [f"{r.get(k, 0.0):.4f}"
                                              for k in keys]))
        return "\n".join(lines)


@register_pass("VideoRecorder")
class VideoRecorder(RenderPass):
    """Keeps a copy of its 'in' channel on the host every frame while
    `recording` is set (the reference drives ffmpeg, VideoRecorder.h:42;
    here the frames are a list of numpy arrays)."""

    SCHEMA = dict(channel=None)

    def __init__(self, props=None):
        super().__init__(props)
        self.frames: list = []
        self.recording = False

    def reflect(self, ctx):
        return PassReflection().add_input("in", optional=True)

    def execute(self, ctx, inputs, state=None):
        if self.recording and "in" in inputs:
            self.frames.append(inputs["in"].detach().cpu().numpy())
        return {}, None
