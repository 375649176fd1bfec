"""harness_ms: per window frame of the traced run, the host time around
Renderer.renderFrame less the time in Renderer.profiler's renderFrame
scope (the graph's frame and its synchronize): the animation step and the
camera path, mean per frame."""
LAYER = "Harness (mogwai.py, scene/animation.py)"
MOVES = "frame_ms"


def read(r):
    h = r.get("harness_ms")
    return sum(h) / len(h) if h else None
