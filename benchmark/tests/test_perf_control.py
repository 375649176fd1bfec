"""The control, the reference computed with bfloat16 render targets (one
step below the float32 the configurations state), is not correct under
each cell's limits, and the program is (tiny copies of the cells on the
CPU; control.py reads both on the card at the cells' own size)."""
import perfutil
import pytest
import torch

import control
from harness import cell

torch.set_num_threads(2)


@pytest.mark.parametrize("name", perfutil.CELLS)
def test_control_fails_and_program_passes(tmp_path, name):
    root, _ = perfutil.tiny_cell(tmp_path, name)
    limits = perfutil.load("workloads", name)["limits"]
    got = control.readings(name, 11, 0.2, True, device="cpu", root=root)
    assert cell.judge(got["lower"], limits)[0]
    assert not cell.judge(got["upper"], limits)[0]
