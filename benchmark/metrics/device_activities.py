"""device_activities: the device activities (kernels, copies, fills) that
torch.profiler recorded in the traced frames, per frame. The profiler
drops a few launch records, so this is a floor."""
LAYER = "Tensor code (passes/*, ops/*)"
MOVES = "frame_ms"


def read(r):
    tr = r.get("trace")
    if not tr or not tr.get("frames"):
        return None
    return tr["activities"] / tr["frames"]
