"""Helpers of the benchmark's CPU tests: import paths and tiny copies of
the real cells (same graph script, outputs and limits; a small town at a
few dozen pixels) that the CPU renders in seconds."""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("emerald_720p.orbit", "bistro_1080p.flyby")
TINY_SCENE = {"n_buildings": 12, "n_props": 20, "columns": 4, "trees": 3,
              "leaves_per_tree": 12, "extent": 18.0}


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def tiny_cell(tmp: Path, cell: str, width: int = 48, height: int = 32):
    """A folder with configs/, workloads/ and metrics/ holding a tiny copy
    of `cell`; returns (root, bench) for harness.cell.run."""
    wl = load("workloads", cell)
    cfg = load("configs", wl["config"])
    cfg = dict(cfg, width=width, height=height,
               scene=dict(cfg["scene"], **TINY_SCENE))
    wl = dict(wl, loop_frames=6, warm_frames=2, compare_frames=[2, 4],
              trace_frames=2)
    anim = wl.get("animation") or {}
    if "camera_orbit" in anim:
        anim = dict(anim, camera_orbit=dict(anim["camera_orbit"],
                                            radius=15.0, height=6.0))
    if "camera_path" in anim:
        # the path drawn in toward its first target, to the tiny town
        path = anim["camera_path"]
        t0 = path["targets"][0]
        anim = dict(anim, camera_path=dict(path, positions=[
            [c + 0.35 * (p - c) for p, c in zip(pos, t0)]
            for pos in path["positions"]]))
    wl["animation"] = anim or None
    for kind, name, data in (("configs", cfg["name"], cfg),
                             ("workloads", cell, wl)):
        (tmp / kind).mkdir(parents=True, exist_ok=True)
        with open(tmp / kind / f"{name}.json", "w") as f:
            json.dump(data, f)
    if not (tmp / "metrics").exists():
        os.symlink(BENCH / "metrics", tmp / "metrics")
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    return tmp, bench
