"""On the card only (marker `cuda`): a short run of each cell prints a
correct result line with every end-to-end metric."""
import json
import subprocess
import sys

import perfutil
import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("name", perfutil.CELLS)
def test_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's kernels run only "
                    "there")
    out = subprocess.run(
        [sys.executable, str(perfutil.BENCH / "run.py"), "--workload", name,
         "--seed", "3", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=perfutil.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p90",
                                   "peak_mem_gib", "setup_s"}
