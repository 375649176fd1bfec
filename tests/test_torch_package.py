"""Package guards of rtsdm_tpu_torch: it never imports jax, a CPU tensor
takes a kernel's plain version (and never counts as a launch), a tensor on
any other non-CUDA device raises instead of falling back, and the kernel
build names the Hopper target and keeps fused multiply-adds off.

This file imports neither jax nor rtsdm_tpu.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rtsdm_tpu_torch
from rtsdm_tpu_torch import _build
from rtsdm_tpu_torch.ops import ao_shift as S
from rtsdm_tpu_torch.ops import fetch_cuda as F
from rtsdm_tpu_torch.ops import raster_cuda as RC
from rtsdm_tpu_torch.ops import rt_cuda as RT

ROOT = Path(__file__).resolve().parents[1]

WRAPPERS = (RC.raster_blocks, RC.fetch_attributes, F.fetch_all_directions,
            F.fetch_sd_packed, RT.sd_trace_blocks)


def test_port_never_imports_jax():
    """Import every module of the package in a fresh interpreter; jax (and
    with it rtsdm_tpu, whose __init__ imports jax) must stay out."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import rtsdm_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'rtsdm_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rtsdm_tpu'))\n"
        "print(len(names), bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 20            # every slice module was imported
    assert bad.strip() == "[]"


def test_precision_policy_is_full_fp32():
    assert rtsdm_tpu_torch.__name__ == "rtsdm_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_build_targets_hopper_without_fma():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build.BUILD_DIR == ROOT / "build" / "rtsdm_tpu_torch"
    assert {p.name for p in _build.CSRC_DIR.glob("*.cu")} == {
        "raster.cu", "fetch.cu", "sd_trace.cu"}
    # the scene helper is built by the port's own loader, into build/
    lib = _build.scenekit_library()
    assert Path(lib._name).parent == _build.BUILD_DIR


def _tiny_inputs():
    """Minimal valid CPU arguments for each of the five wrappers."""
    rng = np.random.default_rng(11)
    chunks = torch.zeros((1, RC.COEF_ROWS, RC.TC))
    lists = torch.zeros((1, 1), dtype=torch.int32)
    counts = torch.ones((1,), dtype=torch.int32)
    tri_id = torch.tensor([[0, -1]], dtype=torch.int32)
    bary = torch.full((1, 2, 2), 0.25)
    table = torch.as_tensor(rng.uniform(size=(1, 7)).astype(np.float32))

    class Cfg:
        num_directions = 2

        def radii(self):
            return np.asarray([0.7, 0.3], np.float32)

    levels, offs, radii = S.offset_tables(Cfg(), 6.0)
    pad = 3
    radius = torch.full((16, 2, 2), 3.0)
    planes = S.pad_planes(torch.as_tensor(
        rng.uniform(size=(16, 2, 2)).astype(np.float32)), pad)
    sd = torch.as_tensor(rng.uniform(size=(2 + 2 * pad, 2 + 2 * pad, 2))
                         .astype(np.float32))
    tri = torch.zeros((1, RT.PACK_ROWS, RT.TC))
    rays = torch.zeros((7, RT.RB))
    return {
        "raster_blocks": (chunks, lists, counts, 1, 1),
        "fetch_attributes": (tri_id, bary, table, 2, 1),
        "fetch_all_directions": ([planes], pad, radius, levels, offs, radii),
        "fetch_sd_packed": (sd, pad, radius, levels, offs, radii, pad),
        "sd_trace_blocks": (tri, lists, counts, rays, 2),
    }


def test_cpu_tensors_take_plain_versions(monkeypatch):
    """Each wrapper hands CPU tensors to its plain version and leaves its
    launch count at 0."""
    plain_calls = []
    for mod, name in ((RC, "raster_blocks_plain"),
                      (RC, "fetch_attributes_plain"),
                      (F, "fetch_all_directions_plain"),
                      (F, "fetch_sd_packed_plain"),
                      (RT, "sd_trace_blocks_plain")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            plain_calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    _build.LAUNCHES.clear()
    args = _tiny_inputs()
    for w in WRAPPERS:
        out = w(*args[w.__name__])
        assert out is not None
    assert plain_calls == [w.__name__ + "_plain" for w in WRAPPERS]
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("wrapper", [w.__name__ for w in WRAPPERS])
def test_other_devices_raise_instead_of_falling_back(wrapper):
    """A tensor that lies neither on the CPU nor on a CUDA device (here the
    meta device) is refused; it never reaches the plain version."""
    args = _tiny_inputs()[wrapper]

    def meta(a):
        if isinstance(a, torch.Tensor):
            return a.to("meta")
        if isinstance(a, list) and a and isinstance(a[0], torch.Tensor):
            return [x.to("meta") for x in a]
        return a
    fn = {w.__name__: w for w in WRAPPERS}[wrapper]
    with pytest.raises(RuntimeError, match="unsupported device"):
        fn(*map(meta, args))
