"""scripts/SVAO.py, the reference's shipped SVAO graph, through the port's
Mogwai harness on the CPU, at the settings of
tests/image_tests/renderpasses/test_SVAO_full.py (CornellBox 128x128, the
script's guard band 64, a paused clock, frames 0 and 1), held against the
committed goldens by the golden runner's MSE bound (2e-4,
rtsdm_tpu/testing/image_tests.py:96-100; measured 1.1e-6 and 1.5e-6). The
goldens are the reference package's own output, rendered op by op (the
golden runner uses use_jit=False); the refs are only read.

One render is shared by every test here. CornellBox has 36 triangles, so
the SD trace takes the resident tier (K7's plain version), on one chunk.
"""
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

from rtsdm_tpu_torch import _build  # noqa: E402
from rtsdm_tpu_torch.mogwai import Renderer, run_script  # noqa: E402
from rtsdm_tpu_torch.ops import rt_cuda as RT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "SVAO.py"
REFS = ROOT / "tests" / "image_refs"
GOLDEN = ROOT / "tests" / "image_tests" / "renderpasses" / "test_SVAO_full.py"
MSE_BOUND = 2e-4

# the passes the reference package runs for this graph after its liveness
# pruning (its RenderGraph.execute; test_reference_liveness_is_this_set)
LIVE = {"GuardBand", "VideoRecorder", "GBufferRaster", "RayShadow",
        "LinearizeDepth", "EnvMapPass", "CompressNormals", "AOFlickerMask",
        "ForwardLighting", "BinaryDilation", "ToneMapper", "SVAO",
        "CrossBilateralBlur0", "TemporalAO", "AOSwitch", "DiffuseRef",
        "AmbientRef", "DiffuseTAA", "DiffuseDLSS", "AmbientTAA",
        "PathBenchmark"}
PRUNED = {"AccumulatePass", "DepthPass", "DepthPeeling", "LinearizeDepth0",
          "RayMinMaxLength"}


def _golden_settings():
    ns = {}
    exec(GOLDEN.read_text(), ns)
    return ns["IMAGE_TEST"], ns["OUTPUTS"]


@pytest.fixture(scope="module")
def svao_full():
    cfg, outputs = _golden_settings()
    m = Renderer(cfg["width"], cfg["height"], device="cpu")
    run_script(str(SCRIPT), m)
    m.loadScene(cfg["scene"])
    m.clock.pause()
    m.profiler.enabled = True
    ran, tiers = [], []
    for name, p in m.active_graph.passes.items():
        def rec(*a, _name=name, _real=p.execute, **kw):
            ran.append(_name)
            return _real(*a, **kw)
        p.execute = rec
    real = {"resident": RT.sd_trace_resident_blocks,
            "stream": RT.sd_trace_blocks}

    def tier(name):
        def f(*a, **kw):
            tiers.append(name)
            return real[name](*a, **kw)
        return f

    _build.LAUNCHES.clear()
    frames = {}
    with mock.patch.object(RT, "sd_trace_resident_blocks", tier("resident")), \
            mock.patch.object(RT, "sd_trace_blocks", tier("stream")):
        for f in range(max(cfg["frames"]) + 1):
            m.clock.frame = f
            frames[f] = m.renderFrame()
    return dict(m=m, cfg=cfg, outputs=outputs, frames=frames, ran=ran,
                tiers=tiers)


@pytest.mark.parametrize("output", ["AmbientRef.out", "AmbientTAA.colorOut"])
def test_svao_full_matches_goldens(svao_full, output):
    assert output in svao_full["outputs"]
    f = svao_full["cfg"]["frames"][0]
    img = svao_full["frames"][f][output].numpy()
    ref = np.load(REFS / f"test_SVAO_full.{output}.{f}.npy").astype(
        np.float32)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    assert float(np.mean((img - ref) ** 2)) <= MSE_BOUND


def test_svao_full_runs_the_reference_passes(svao_full):
    """The same passes run as in the reference package, once per frame,
    and the SD trace takes the resident tier every frame (plain versions:
    no kernel launch on the CPU)."""
    assert set(svao_full["ran"]) == LIVE
    assert len(svao_full["ran"]) == 2 * len(LIVE)
    assert svao_full["tiers"] == ["resident", "resident"]
    assert sum(_build.LAUNCHES.values()) == 0
    assert set(svao_full["m"].active_graph.passes) == LIVE | PRUNED


def test_reference_liveness_is_this_set():
    """The reference package's RenderGraph.execute on the same script runs
    exactly LIVE (every pass's execute stubbed to give its declared
    outputs, so nothing is rendered)."""
    from rtsdm_tpu.mogwai import Renderer as RendererJ
    from rtsdm_tpu.mogwai import run_script as run_script_j
    from rtsdm_tpu.rendergraph.render_pass import RenderContext as RCJ
    m = RendererJ(128, 128, use_jit=False)
    run_script_j(str(SCRIPT), m)
    g = m.active_graph
    ctx = RCJ(width=256, height=256, dictionary={"guardBand": 64})
    ran = []
    for name, p in g.passes.items():
        def stub(c, inputs, state=None, _name=name, _p=p):
            ran.append(_name)
            return {o.name: None for o in _p.reflect(c).outputs}, None
        p.execute = stub
    g.execute(ctx, {})
    assert set(ran) == LIVE and len(ran) == len(LIVE)


def test_svao_full_outputs(svao_full):
    """Every marked output at the requested size and finite, the AO in
    [0, 1], the DLSS stub's output its input, and the profiler's rows in
    PathBenchmark (one per frame)."""
    out = svao_full["frames"][1]
    for k, v in out.items():
        assert v.shape[:2] == (128, 128), k
        assert bool(torch.isfinite(v).all()), k
    ao = out["AmbientRef.out"][..., 0]
    assert float(ao.min()) >= 0.0 and float(ao.max()) <= 1.0
    assert torch.equal(out["DiffuseDLSS.output"], out["DiffuseRef.out"])
    bench = svao_full["m"].active_graph.get_pass("PathBenchmark")
    assert len(bench.rows) == 2
    assert "renderFrame/SVAO" in bench.rows[1]
    assert len(bench.csv().splitlines()) == 3
