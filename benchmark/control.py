"""The readings the comparison's limits are set from, on the card at a
cell's own size (the benchmark's runs do not run this):

    python3 benchmark/control.py --workload emerald_720p.orbit \
        --seeds 1,2,3 --seconds 3 [--control]

For each seed, one process renders the cell as a run does (set-up and a
short window), keeps the compared frame and set-up's first frame, and
prints one JSON line: the program's mean squared differences from the
reference (the lower readings), those of the frame before it and the state
it started from (a frame that never advanced: a fault's readings) and,
with --control, the reference's own
in bfloat16 render targets (the control: one precision step below the
float32 the configuration states) against the float32 reference (the
upper readings).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def readings(cell_name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", root=None) -> dict:
    import torch

    from harness import cell, discover
    root = root or discover.HERE
    wl = discover.load_json("workloads", cell_name, root)
    cfg = discover.load_json("configs", wl["config"], root)
    arrays, camera = cell.inputs(cfg, wl, seed)
    _, kept = cell.run_program(cfg, wl, arrays, camera, seed, seconds,
                               False, device, time.perf_counter(),
                               keep_prev=True)
    names = wl["outputs"]
    prog = (kept["compared"], cell.state_tensors(kept["state"]),
            kept["start"])
    out = {"seed": seed, "frame": kept["frame"]}
    t = time.perf_counter()
    ref = cell.reference_checks(cfg, wl, arrays, camera, kept, device)[:3]
    out["lower"] = cell.numbers_of(*prog, *ref, names)
    # a frame that never advanced: the frame before's outputs and state
    out["stale"] = cell.numbers_of(
        kept["compared_prev"], cell.state_tensors(kept["state_prev"]),
        kept["start"], *ref, names)
    out["reference_s"] = time.perf_counter() - t
    if control:
        t = time.perf_counter()
        ctl = cell.reference_checks(cfg, wl, arrays, camera, kept, device,
                                    torch.bfloat16)[:3]
        out["upper"] = cell.numbers_of(*ctl, *ref, names)
        out["control_s"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds,
                                  args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
