"""No run loads JAX or the JAX package, compared by whole top-level
names; the reference loads nothing of the program."""
import ast
import json
import subprocess
import sys

import perfutil
import pytest

from harness import guard


@pytest.mark.parametrize("names,found", [
    (["rtsdm_tpu_torch", "rtsdm_tpu_torch.ops.raster"], []),
    (["rtsdm_tpu.scene"], ["rtsdm_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "rtsdm_tpu_torchx"], []),
])
def test_names_compared_whole(names, found):
    assert guard.forbidden_loaded(dict.fromkeys(names)) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_under_the_benchmark_imports_jax():
    for path in perfutil.BENCH.rglob("*.py"):
        tops = {guard.top_level(n) for n in _imports(path)}
        assert not tops & guard.FORBIDDEN, path
        if "reference" in path.parts:
            assert guard.PROGRAM not in tops, path


_RUN = """
import json, sys, time
from pathlib import Path
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
import perfutil
from harness import cell, guard
root, bench = perfutil.tiny_cell(Path({tmp!r}), "emerald_720p.orbit")
{body}
"""


def _run(tmp_path, body):
    code = _RUN.format(bench=str(perfutil.BENCH), root=str(perfutil.ROOT),
                       tests=str(perfutil.BENCH / "tests"),
                       tmp=str(tmp_path), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    got = _run(tmp_path, """
cell.run("emerald_720p.orbit", bench, 5, 0.5, False, time.perf_counter(),
         device="cpu", root=root)
print(json.dumps(guard.forbidden_loaded()))
""")
    assert got == []


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    got = _run(tmp_path, """
from harness import discover
wl = discover.load_json("workloads", "emerald_720p.orbit", root)
cfg = discover.load_json("configs", wl["config"], root)
arrays, camera = cell.inputs(cfg, wl, 2)
cell.reference_frame(cfg, wl, arrays, camera, 1, None, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {guard.PROGRAM, *guard.FORBIDDEN})))
""")
    assert got == []
