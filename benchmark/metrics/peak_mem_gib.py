"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window (reset at process start), in GiB; None off the card."""
LAYER = "end to end"
MOVES = None


def read(r):
    peak = r.get("peak_bytes")
    return None if peak is None else peak / 2**30
