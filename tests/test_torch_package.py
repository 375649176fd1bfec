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

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

import rtsdm_tpu_torch
from rtsdm_tpu_torch import _build
from rtsdm_tpu_torch.ops import ao as A
from rtsdm_tpu_torch.ops import ao_shift as S
from rtsdm_tpu_torch.ops import fetch_cuda as F
from rtsdm_tpu_torch.ops import raster_cuda as RC
from rtsdm_tpu_torch.ops import resolve_cuda as RV
from rtsdm_tpu_torch.ops import rt_cuda as RT
from rtsdm_tpu_torch.ops import warp_cuda as W
from rtsdm_tpu_torch.passes import svao_shift as PH

ROOT = Path(__file__).resolve().parents[1]

WRAPPERS = (RC.raster_blocks, RC.fetch_attributes, F.fetch_all_directions,
            F.fetch_sd_packed, RT.sd_trace_blocks, W.warp_resample,
            RT.any_hit_blocks, F.fetch_taps_same_class,
            RC.raster_stochastic_blocks, RT.sd_trace_resident_blocks,
            F.fetch_sd_strided, RV.svao_resolve)


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
        "raster.cu", "fetch.cu", "sd_trace.cu", "warp.cu", "any_hit.cu",
        "raster_sd.cu", "svao_resolve.cu"}
    # the scene helper is built by the port's own loader, into build/
    lib = _build.scenekit_library()
    assert Path(lib._name).parent == _build.BUILD_DIR


def _tiny_inputs():
    """Minimal valid CPU arguments for each of the twelve wrappers."""
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
    tri = torch.zeros((1, RT.TC, RT.PACK_W))
    rays = torch.zeros((7, RT.RB))
    svao_cfg = A.VAOConfig(num_directions=2, resolution=(8, 8),
                           low_resolution=(8, 8))
    bq = {k: torch.ones((16, 2, 2)) for k in ("radius_px", "radius",
                                              "pos_len")}
    bq.update({k: tuple(torch.ones((16, 2, 2)) for _ in range(3))
               for k in ("a", "no")}, sx=torch.ones(()), sy=torch.ones(()))
    return {
        "raster_blocks": (chunks, torch.zeros((1, 4, RC.TC)), lists, counts,
                          1, 1),
        "fetch_attributes": (tri_id, bary, table, 2, 1),
        "fetch_all_directions": ([planes], pad, radius, levels, offs, radii),
        "fetch_sd_packed": (sd, pad, radius, levels, offs, radii, pad),
        "sd_trace_blocks": (tri, torch.zeros((8, 1)), torch.zeros(3), rays,
                            2),
        "warp_resample": (torch.ones((1, 2, 2)), torch.ones((1, 2)),
                          torch.ones((1, 2)), "bilinear"),
        "any_hit_blocks": (torch.zeros((1, RT.PACK_ROWS_CLASSIC, RT.TC)),
                           torch.zeros((1, 6, RT.N_CULL)), lists, counts,
                           torch.zeros((8, RT.RB))),
        "fetch_taps_same_class": (planes[None],
                                  torch.zeros((4, 16, 2, 2),
                                              dtype=torch.int32),
                                  pad, [[[(1, -1)]] * 16] * 8),
        "raster_stochastic_blocks": (chunks, torch.zeros((1, 4, RC.TC)),
                                     lists, counts, 1, 1,
                                     torch.zeros((8, 32)),
                                     torch.zeros((8, 32)),
                                     torch.ones((8, 32)), 4, 0.375),
        "sd_trace_resident_blocks": (tri, torch.zeros((6, 1)),
                                     torch.zeros(3), rays, 2),
        "fetch_sd_strided": (sd, pad, radius, levels, offs, radii, 1, 1),
        "svao_resolve": (svao_cfg, bq, levels, radii,
                         torch.ones((2, 16, 2, 2)), torch.ones((16, 2, 2, 2)),
                         torch.ones((16, 2, 2), dtype=torch.int32),
                         torch.ones(()), torch.zeros(()), 2, 1, True, None,
                         0),
    }


def test_cpu_tensors_take_plain_versions(monkeypatch):
    """Each wrapper hands CPU tensors to its plain version and leaves its
    launch count at 0."""
    plain_calls = []
    for mod, name in ((RC, "raster_blocks_plain"),
                      (RC, "fetch_attributes_plain"),
                      (F, "fetch_all_directions_plain"),
                      (F, "fetch_sd_packed_plain"),
                      (RT, "sd_trace_blocks_plain"),
                      (W, "warp_resample_plain"),
                      (RT, "any_hit_blocks_plain"),
                      (F, "fetch_taps_same_class_plain"),
                      (RC, "raster_stochastic_blocks_plain"),
                      (RT, "sd_trace_resident_blocks_plain"),
                      (F, "fetch_sd_strided_plain"),
                      (PH, "svao_resolve_plain")):
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


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py imports the port only: no jax and no module of the
    reference package, at top level or inside a function."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "rtsdm_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "rtsdm_tpu"}, sorted(tops)


def _entry_points():
    from rtsdm_tpu_torch.mogwai import Renderer
    from rtsdm_tpu_torch.scene import procedural as P
    from rtsdm_tpu_torch.scene.animation import (AnimationController,
                                                 CameraPath, NodeTrack)
    from rtsdm_tpu_torch.scene.camera import CAMERA_FIELDS, Camera
    from rtsdm_tpu_torch.scene.scene import (SCENE_FIELDS, make_scene,
                                             scene_from_numpy)
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)

    def from_numpy(**kw):
        st = P.cornell_box(device="cpu")
        arrays = {f: (None if getattr(st, f) is None
                      else getattr(st, f).numpy()) for f in SCENE_FIELDS}
        cam = {f: getattr(st.camera, f).numpy() for f in CAMERA_FIELDS}
        return scene_from_numpy(arrays, cam, **kw)

    return {
        "cornell_box": P.cornell_box,
        "arcade": P.arcade,
        "sun_temple": P.sun_temple,
        "bistro": P.bistro,
        "emerald_square": P.emerald_square,
        "load_scene": lambda **kw: P.load_scene("CornellBox", **kw),
        "make_scene": lambda **kw: make_scene("tri", tri, **kw),
        "scene_from_numpy": from_numpy,
        "Camera.create": Camera.create,
        "Camera.create(prev=)": lambda **kw: Camera.create(
            position=(0.0, 1.0, 3.0), prev=Camera.create(**kw), **kw),
        "CameraPath.camera_at": lambda **kw: CameraPath.orbit(
            (0.0, 0.0, 0.0), 3.0, 1.0).camera_at(0.5, Camera.create(**kw)),
        "AnimationController.animate": lambda **kw: AnimationController(
            {1: NodeTrack.oscillate((0.0, 1.0, 0.0), 0.5, 4.0)}).animate(
            P.cornell_box(**kw), 0.5),
        "Renderer": lambda **kw: Renderer(64, 64, **kw),
    }


ENTRY_POINTS = ("cornell_box", "arcade", "sun_temple", "bistro",
                "emerald_square", "load_scene", "make_scene",
                "scene_from_numpy", "Camera.create", "Camera.create(prev=)",
                "CameraPath.camera_at", "AnimationController.animate",
                "Renderer")


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_gpu(entry, monkeypatch):
    """Every public entry point runs on the card unless it is asked for the
    CPU: without a CUDA device, a call that names no device raises, and the
    same call with device="cpu" builds on the CPU."""
    fn = _entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    out = fn(device="cpu")
    dev = getattr(out, "device", None) or out.view_mat.device
    assert torch.device(dev).type == "cpu"
