"""frame_ms_p90: the 90th percentile of every window frame's host time
around Renderer.renderFrame (the slow frames of a flythrough)."""
from harness import stats

LAYER = "end to end"
MOVES = None


def read(r):
    return stats.percentile(r["frame_ms"], 90.0)
