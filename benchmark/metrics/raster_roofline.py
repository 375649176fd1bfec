"""raster_roofline: 100 x the least time the compared frame's raster calls
could take on the card (harness/roofline.py: the coverages the reference
found, the triangles read and the pixels written, against the float32
and memory peaks) over K1's device time per traced frame (kernels named
raster_blocks_kernel, csrc/raster.cu). None when the trace has no such
kernel."""
from harness import roofline, trace

LAYER = "Kernels (csrc/*.cu)"
MOVES = "frame_ms"
KERNEL = "raster_blocks_kernel"


def read(r):
    tr = r.get("trace")
    calls = (r.get("reference") or {}).get("raster")
    if not tr or not tr.get("frames") or not calls:
        return None
    t = trace.kernel_seconds(tr, KERNEL)
    if not t:
        return None
    return 100.0 * roofline.raster_bound_s(calls) / (t / tr["frames"])
