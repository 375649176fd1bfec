"""Finds a cell's files by name. A configuration is configs/<name>.json, a
cell (a configuration under a traffic mix) workloads/<name>.json and a
metric metrics/<name>.py: adding one is adding its file and its entry in
BENCHMARK.json, never editing a file that is there."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent     # the benchmark's folder
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{_check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, root: Path = HERE):
    """The reader module of metric `name` (metrics/<name>.py): it defines
    read(readings) -> float | None."""
    path = root / "metrics" / f"{_check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"metric reader {path} has no read()")
    return mod


def load_benchmark(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries of BENCHMARK.json a run of `cell` reports: with
    trace its per-layer metrics, without its end-to-end ones. An entry with
    a `workloads` key counts where it lists the cell; a per-layer entry
    without one counts in every cell that reports the end-to-end metric it
    moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")
