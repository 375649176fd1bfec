"""The port's Mogwai harness (rtsdm_tpu_torch.mogwai) against the JAX
package's, on the CPU.

* scripts/SVAO_small.py, the graph of the README's four outputs, run through
  the port's Renderer at the settings of
  tests/image_tests/renderpasses/test_SVAO_small.py (CornellBox 96x96,
  guard band 8, its pass overrides, a paused clock, frames 0 and 1) and held
  against the committed goldens, which are the JAX package's own output of
  this graph, by the golden runner's MSE bound (2e-4,
  rtsdm_tpu/testing/image_tests.py:96-100). The refs are only read.
* Both packages' run_script in one process, in both orders: each builds its
  own package's RenderGraph although scripts/_graphlib.py binds
  `from falcor import RenderGraph` once per process.
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

from rtsdm_tpu_torch import _build
from rtsdm_tpu_torch.mogwai import Renderer, run_script
from rtsdm_tpu_torch.rendergraph.graph import RenderGraph

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "SVAO_small.py"
REFS = ROOT / "tests" / "image_refs"
GOLDEN = ROOT / "tests" / "image_tests" / "renderpasses" / "test_SVAO_small.py"
MSE_BOUND = 2e-4


def _golden_settings():
    ns = {}
    exec(GOLDEN.read_text(), ns)
    return ns["IMAGE_TEST"], ns["OUTPUTS"]


@pytest.fixture(scope="module")
def svao_small_frames():
    cfg, outputs = _golden_settings()
    m = Renderer(cfg["width"], cfg["height"], device="cpu")
    run_script(str(SCRIPT), m)
    assert isinstance(m.active_graph, RenderGraph)
    m.active_graph.get_pass("GuardBand").cfg["guardBand"] = cfg["guard_band"]
    for name, props in cfg["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    m.loadScene(cfg["scene"])
    m.clock.pause()
    _build.LAUNCHES.clear()
    frames = {}
    for f in range(max(cfg["frames"]) + 1):
        m.clock.frame = f
        frames[f] = m.renderFrame()
    assert sum(_build.LAUNCHES.values()) == 0   # CPU tensors: plain versions
    return cfg, outputs, frames


def test_svao_small_outputs_are_cropped_and_finite(svao_small_frames):
    cfg, _, frames = svao_small_frames
    for out in frames.values():
        assert set(out) == {"ShadedTAA.colorOut", "AmbientOcclusionTAA.colorOut",
                            "Shaded.out", "AmbientOcclusion.out"}
        for v in out.values():
            assert v.shape[:2] == (cfg["height"], cfg["width"])
            assert bool(torch.isfinite(v).all())
        ao = out["AmbientOcclusion.out"][..., 0]
        assert float(ao.min()) >= 0.0 and float(ao.max()) <= 1.0


@pytest.mark.parametrize("output", ["AmbientOcclusion.out", "Shaded.out"])
def test_svao_small_matches_goldens(svao_small_frames, output):
    cfg, outputs, frames = svao_small_frames
    assert output in outputs
    for f in cfg["frames"]:
        path = REFS / f"test_SVAO_small.{output}.{f}.npy"
        before = hashlib.sha256(path.read_bytes()).hexdigest()
        ref = np.load(path).astype(np.float32)
        img = frames[f][output].numpy().astype(np.float32)
        assert img.shape == ref.shape
        mse = float(((img - ref) ** 2).mean())
        assert mse <= MSE_BOUND, (output, f, mse)
        assert hashlib.sha256(path.read_bytes()).hexdigest() == before


GOLDENS = ROOT / "tests" / "image_tests"


def _render_golden(test_file):
    """The golden runner's steps (rtsdm_tpu/testing/image_tests.py:
    run_test) through the port's Renderer on the CPU: the test's script,
    guard band and pass overrides, a paused clock, frames 0..max; returns
    (settings, {output.frame: image}) for the frames and outputs it
    keeps."""
    ns = {}
    exec(test_file.read_text(), ns)
    cfg = ns["IMAGE_TEST"]
    m = Renderer(cfg["width"], cfg["height"], device="cpu")
    run_script(str(ROOT / ns["SCRIPT"]), m)
    if "guard_band" in cfg:
        m.active_graph.get_pass("GuardBand").cfg["guardBand"] = \
            cfg["guard_band"]
    for name, props in cfg.get("pass_overrides", {}).items():
        m.active_graph.get_pass(name).cfg.update(props)
    m.loadScene(cfg["scene"])
    m.clock.pause()
    out = {}
    for f in range(max(cfg["frames"]) + 1):
        m.clock.frame = f
        frame = m.renderFrame()
        if f in cfg["frames"]:
            out.update({f"{k}.{f}": v.numpy().astype(np.float32)
                        for k, v in frame.items()
                        if k in ns.get("OUTPUTS", frame)})
    return cfg, out


@pytest.mark.parametrize("golden", [
    "renderpasses/test_Forward.py", "renderpasses/test_Forward_arcade.py",
    "renderscripts/test_TAA_sweep.py", "renderpasses/test_SVAO_guardband.py",
    "renderpasses/test_SVAO_dualAO.py"])
def test_port_renders_golden(golden):
    """Goldens the port renders that no other port test holds (the JAX
    package's output of the same script and settings), by the golden
    runner's MSE bound: Forward.py (RayShadow's K8, ForwardLighting, TAA;
    CornellBox and Arcade), its TAA sweep at frame 2, SVAO_small.py
    with a 32-pixel guard band on 256x256, and with SVAO's dualAO on
    128x128 (measured MSE 1.5e-6)."""
    path = GOLDENS / golden
    cfg, images = _render_golden(path)
    assert cfg["tolerance"] == MSE_BOUND
    name = path.stem
    refs = sorted(REFS.glob(f"{name}.*.npy"))
    assert refs and sorted(images) == sorted(
        p.name[len(name) + 1:-len(".npy")] for p in refs)
    for ref_path in refs:
        ref = np.load(ref_path).astype(np.float32)
        img = images[ref_path.name[len(name) + 1:-len(".npy")]]
        assert img.shape == ref.shape, ref_path.name
        mse = float(((img - ref) ** 2).mean())
        assert mse <= MSE_BOUND, (ref_path.name, mse)


QUARTER = GOLDENS / "renderpasses" / "test_SVAO_quarter.py"
QUARTER_NOFMA = ROOT / "tests" / "torch_refs" / "test_SVAO_quarter.nofma.npz"
NOFMA_BOUND = 1e-9


def test_port_renders_svao_quarter_golden():
    """scripts/SVAO_quarter.py, BASELINE config 4's graph (DownsamplePass,
    SVAO with dualAO at quarter res, AOGuidedBlur), at its golden settings
    (CornellBox 96x96). ShadedTAA.colorOut lies within the golden runner's
    MSE bound of the committed golden (measured 6.2e-6). Both outputs lie
    within MSE 1e-9 (measured 3.7e-12 and 9.1e-13) of the JAX package's
    render of the same settings with XLA's fused multiply-adds off
    (make_refs.py --golden test_SVAO_quarter). The committed AO golden
    comes from the package's compiled CPU raster, which contracts a*b+c in
    its edge functions where the port's raster (and K1) does not: 31
    pixels along one edge of the box show the other face, DownsamplePass's
    point sample keeps two of them and the AO moves by 0.23 there. The
    package without fused multiply-adds is as far from that golden as the
    port (2.046e-4, recorded in the file), just above the runner's bound."""
    cfg, images = _render_golden(QUARTER)
    assert cfg["tolerance"] == MSE_BOUND
    with np.load(QUARTER_NOFMA) as f:
        want = {k: f[k] for k in f.files if k != "settings"}
        recorded = json.loads(str(f["settings"]))
    assert recorded["test"] == QUARTER.stem
    assert "--xla_cpu_max_isa=AVX" in recorded["xla_flags"]
    assert sorted(images) == sorted(want) == [
        "AmbientOcclusion.out.1", "ShadedTAA.colorOut.1"]
    for key, img in images.items():
        golden = np.load(REFS / f"{QUARTER.stem}.{key}.npy").astype(
            np.float32)
        assert img.shape == want[key].shape == golden.shape, key
        mse = float(((img - want[key]) ** 2).mean())
        assert mse <= NOFMA_BOUND, (key, mse)
        mse_golden = float(((img - golden) ** 2).mean())
        assert mse_golden == pytest.approx(recorded["mse_vs_golden"][key],
                                           rel=1e-3), key
    assert recorded["mse_vs_golden"]["ShadedTAA.colorOut.1"] <= MSE_BOUND


HARNESS_ORDERS = """
import sys
sys.path.insert(0, {root!r})
import rtsdm_tpu_torch.mogwai as TM
import rtsdm_tpu_torch.rendergraph.graph as TG
script = {script!r}

def port():
    m, _ = TM.run_script(script, TM.Renderer(64, 64, device="cpu"))
    return type(m.active_graph) is TG.RenderGraph

def reference():
    import rtsdm_tpu.mogwai as JM
    import rtsdm_tpu.rendergraph.graph as JG
    m, _ = JM.run_script(script, JM.Renderer(64, 64, use_jit=False))
    return type(m.active_graph) is JG.RenderGraph

steps = {steps!r}
print(" ".join(str(globals()[s]()) for s in steps))
"""


@pytest.mark.parametrize("steps", [("reference", "port", "reference"),
                                   ("port", "reference", "port")])
def test_both_harnesses_in_one_process(steps):
    """Each run_script builds its own package's graph, whichever package
    ran a script first in the process (the `falcor` / `_graphlib` trap)."""
    code = HARNESS_ORDERS.format(root=str(ROOT), script=str(SCRIPT),
                                 steps=list(steps))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["True"] * len(steps), res.stdout


PLUGIN = '''
from rtsdm_tpu_torch.rendergraph.render_pass import (PassReflection,
                                                     RenderPass, register_pass)


@register_pass("TestHalfAO")
class TestHalfAO(RenderPass):
    def reflect(self, ctx):
        return PassReflection().add_input("src").add_output("dst")

    def execute(self, ctx, inputs, state=None):
        return {"dst": inputs["src"] * 0.5}, None
'''

SCRIPT_WITH_PLUGIN = '''
from falcor import *

g = RenderGraph("PluginGraph")
g.addPass(createPass("GBufferRaster", {}), "GBufferRaster")
g.addPass(createPass("LinearizeDepth", {}), "LinearizeDepth")
g.addPass(createPass("TestHalfAO", {}), "Half")
g.addEdge("GBufferRaster.depth", "LinearizeDepth.depth")
g.addEdge("LinearizeDepth.linearDepth", "Half.src")
g.markOutput("Half.dst")
m.addGraph(g)
'''


def test_mogwai_main_runs_a_script_with_a_plugin(tmp_path, capsys):
    """The command line of the harness (the reference's flags): a plugin
    registers a pass type, the script wires it, two frames render on the
    CPU and their marked output is captured."""
    from rtsdm_tpu_torch import mogwai
    from rtsdm_tpu_torch.rendergraph.render_pass import PASS_REGISTRY
    plugin = tmp_path / "half_plugin.py"
    plugin.write_text(PLUGIN)
    script = tmp_path / "plugin_graph.py"
    script.write_text(SCRIPT_WITH_PLUGIN)
    try:
        rc = mogwai.main([str(script), "--scene", "CornellBox", "--width",
                          "40", "--height", "24", "--frames", "2",
                          "--device", "cpu", "--plugin", str(plugin),
                          "--capture", str(tmp_path / "out")])
    finally:
        PASS_REGISTRY.pop("TestHalfAO", None)
    assert rc == 0
    assert "outputs: {'Half.dst': (24, 40)}" in capsys.readouterr().out
    for f in (0, 1):
        img = np.load(tmp_path / "out"
                      / f"Mogwai.PluginGraph.Half.dst.{f}.npy")
        assert img.shape == (24, 40) and np.isfinite(img).all()


SCRIPT_DEPTH = '''
from falcor import *

g = RenderGraph("DepthGraph")
g.addPass(createPass("GBufferRaster", {}), "GBufferRaster")
g.addPass(createPass("LinearizeDepth", {}), "LinearizeDepth")
g.addEdge("GBufferRaster.depth", "LinearizeDepth.depth")
g.markOutput("LinearizeDepth.linearDepth")
g.markOutput("GBufferRaster.faceNormalW")
m.addGraph(g)
'''


def test_capture_names_files_as_the_reference(tmp_path):
    """mogwai --capture goes through m.frameCapture as the reference's does
    (rtsdm_tpu/mogwai.py:365-367). On CornellBox 64x64, two frames of a
    G-buffer graph: the port's command line writes the same files, with
    the same arrays (exactly), as the JAX package's FrameCapture
    (rtsdm_tpu/core/frame_capture.py) attached to a port Renderer that
    rendered the same frames: <base>.<graph>.<output>.<frame>.npy and a
    .png preview."""
    from rtsdm_tpu.core.frame_capture import FrameCapture as FrameCaptureJ
    from rtsdm_tpu_torch import mogwai
    from rtsdm_tpu_torch.core.frame_capture import FrameCapture
    script = tmp_path / "depth_graph.py"
    script.write_text(SCRIPT_DEPTH)
    want_dir, got_dir = tmp_path / "ref", tmp_path / "port"
    m, _ = run_script(str(script), Renderer(64, 64, device="cpu"))
    m.loadScene("CornellBox")
    m.clock.pause()
    ref_cap = FrameCaptureJ()
    ref_cap._attach(m)
    ref_cap.outputDir = str(want_dir)
    for f in (0, 1):
        m.clock.frame = f
        m.renderFrame()
        ref_cap.capture()
    assert mogwai.main([str(script), "--scene", "CornellBox", "--width",
                        "64", "--height", "64", "--frames", "2", "--device",
                        "cpu", "--capture", str(got_dir)]) == 0
    want = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == want
    assert "Mogwai.DepthGraph.LinearizeDepth.linearDepth.1.npy" in want
    assert "Mogwai.DepthGraph.GBufferRaster.faceNormalW.0.png" in want
    for name in want:
        if name.endswith(".npy"):
            a, b = np.load(got_dir / name), np.load(want_dir / name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    cap = FrameCapture()
    for fmt in ("exr", "png"):
        cap.format = fmt
        with pytest.raises(NotImplementedError, match="queue 1, item 11"):
            cap.capture()
