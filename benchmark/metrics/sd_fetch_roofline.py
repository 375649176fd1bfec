"""sd_fetch_roofline: 100 x the least time one frame's phase-2 SD fetch
could take on the card (harness/roofline_sd_fetch.py: each fetched value
written once and the SD map read once, counted from the configuration,
against the memory's peak) over the fetch kernel's device time per traced
frame (kernels named fetch_sd_strided_kernel, csrc/fetch.cu). None when
the trace has no such kernel."""
from harness import roofline_sd_fetch, trace

LAYER = "Kernels (csrc/*.cu)"
MOVES = "frame_ms"
KERNEL = "fetch_sd_strided_kernel"


def read(r):
    tr = r.get("trace")
    cfg = r.get("config")
    if not tr or not tr.get("frames") or not cfg:
        return None
    bound = roofline_sd_fetch.sd_fetch_bound_s(cfg)
    t = trace.kernel_seconds(tr, KERNEL)
    if bound is None or not t:
        return None
    return 100.0 * bound / (t / tr["frames"])
