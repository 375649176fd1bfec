"""idle_share: 100 x (1 - the union of the device activities' intervals /
the wall time of the traced frames), on one H100."""
from harness import stats

LAYER = "Device (one H100)"
MOVES = "frame_ms"


def read(r):
    tr = r.get("trace")
    if not tr or not tr.get("frames") or tr["window_s"] <= 0:
        return None
    return stats.idle_share_pct(tr["busy_s"], tr["window_s"])
