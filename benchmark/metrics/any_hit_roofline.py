"""any_hit_roofline: 100 x the least time the compared frame's shadow
any-hit calls could take on the card (harness/roofline.py: the pairs whose
triangle box a live ray's segment meets, the triangles and rays read, the
answers written) over K8's device time per traced frame (kernels named
any_hit_kernel, csrc/any_hit.cu). None when the trace has no such
kernel."""
from harness import roofline, trace

LAYER = "Kernels (csrc/*.cu)"
MOVES = "frame_ms"
KERNEL = "any_hit_kernel"


def read(r):
    tr = r.get("trace")
    calls = (r.get("reference") or {}).get("any_hit")
    if not tr or not tr.get("frames") or not calls:
        return None
    t = trace.kernel_seconds(tr, KERNEL)
    if not t:
        return None
    return 100.0 * roofline.any_hit_bound_s(calls) / (t / tr["frames"])
