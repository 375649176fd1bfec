"""A configuration, a cell and a metric are added as files only, and every
entry of BENCHMARK.json has its files."""
import json
import re

import perfutil
import pytest

from harness import discover


def test_throwaway_files_are_found_by_name(tmp_path):
    for kind in ("configs", "workloads", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "toy_cfg.json").write_text(
        json.dumps({"name": "toy_cfg", "width": 8, "height": 8}))
    (tmp_path / "workloads" / "toy_cfg.mix.json").write_text(
        json.dumps({"config": "toy_cfg", "traffic": "mix"}))
    (tmp_path / "metrics" / "toy.metric.py").write_text(
        "LAYER = 'toy'\nMOVES = 'frame_ms'\n\n"
        "def read(r):\n    return r['x'] * 2\n")
    wl = discover.load_json("workloads", "toy_cfg.mix", tmp_path)
    cfg = discover.load_json("configs", wl["config"], tmp_path)
    assert cfg["width"] == 8
    assert discover.load_metric("toy.metric", tmp_path).read({"x": 2}) == 4
    bench = {"end_to_end": [{"name": "frame_ms"}, {"name": "only_b",
                                                   "workloads": ["b"]}],
             "per_layer": [{"name": "toy.metric", "moves": "frame_ms"},
                           {"name": "listed", "moves": "only_b",
                            "workloads": ["b"]}]}
    assert [m["name"] for m in discover.cell_metrics(bench, "a", False)] \
        == ["frame_ms"]
    assert [m["name"] for m in discover.cell_metrics(bench, "a", True)] \
        == ["toy.metric"]
    assert [m["name"] for m in discover.cell_metrics(bench, "b", True)] \
        == ["toy.metric", "listed"]
    with pytest.raises(FileNotFoundError):
        discover.load_metric("absent", tmp_path)
    with pytest.raises(ValueError):
        discover.load_json("configs", "../escape", tmp_path)


def test_every_entry_has_its_files():
    bench = json.loads((perfutil.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((perfutil.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        wl = perfutil.load("workloads", w["name"])
        assert (wl["config"], wl["traffic"], wl["why"]) == \
            (w["config"], w["traffic"], w["why"])
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = discover.load_metric(m["name"])
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_names_and_limits_of_the_contract():
    bench = json.loads((perfutil.ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(set(names)) == len(names)
        assert all(name.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(bench)) <= 64 * 1024
