"""setup_s: process start to the first timed frame (imports, the kernel
build cache, scene generation, upload, graph build, warm-up frames)."""
LAYER = "end to end"
MOVES = None


def read(r):
    return r["setup_s"]
