"""sd_trace_device_ms: K5's device time per traced frame, in ms (kernels
named sd_trace_kernel, csrc/sd_trace.cu: the streamed stochastic-depth
trace; K7, sd_trace_resident_kernel, is not counted). None when the trace
has no such kernel."""
from harness import trace

LAYER = "Kernels (csrc/*.cu)"
MOVES = "frame_ms"
KERNEL = "sd_trace_kernel"


def read(r):
    tr = r.get("trace")
    if not tr or not tr.get("frames"):
        return None
    t = trace.kernel_seconds(tr, KERNEL)
    if not t:
        return None
    return 1e3 * t / tr["frames"]
