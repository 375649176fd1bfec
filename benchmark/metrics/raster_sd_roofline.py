"""raster_sd_roofline: 100 x the least time the compared frame's
stochastic-depth raster calls could take on the card (harness/
roofline_raster_sd.py: the coverages and insertions the reference found,
the triangles read and the SD texels read and written, against the
float32 and memory peaks) over K9's device time per traced frame (kernels
named raster_sd_kernel, csrc/raster_sd.cu). None when the trace has no
such kernel or the reference recorded no K9 call."""
from harness import roofline_raster_sd, trace

LAYER = "Kernels (csrc/*.cu)"
MOVES = "frame_ms"
KERNEL = "raster_sd_kernel"


def read(r):
    tr = r.get("trace")
    calls = roofline_raster_sd.raster_sd_calls(
        (r.get("reference") or {}).get("raster"))
    if not tr or not tr.get("frames") or not calls:
        return None
    t = trace.kernel_seconds(tr, KERNEL)
    if not t:
        return None
    return 100.0 * roofline_raster_sd.raster_sd_bound_s(calls) \
        / (t / tr["frames"])
