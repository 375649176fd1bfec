"""frame_ms: the window's wall time over the frames it completed, every
frame counted (host clock; each frame ends in a synchronize)."""
from harness import stats

LAYER = "end to end"
MOVES = None


def read(r):
    return stats.window_rate_ms(r["window_s"], r["frames"])
