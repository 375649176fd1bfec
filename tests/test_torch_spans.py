"""The profiler's spans inside rtsdm_tpu_torch, on the CPU at a tiny size:
one scripts/SVAO_small.py frame of an animated CornellBox under
torch.profiler, whose Chrome trace holds the program's record_function
spans ("rtsdm/" + the scope path) beside the profiler's own tree, and one
frame with the profiler off, which enters no span at all."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tier-1 runs six test workers side by side: one intra-op thread each keeps
# them from oversubscribing the cores (several times the CPU time otherwise)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from rtsdm_tpu_torch.core import profiler as PR  # noqa: E402
from rtsdm_tpu_torch.scene import animation as AT  # noqa: E402

PREFIX = PR.SPAN_PREFIX
LAYERED = ("geometry.", "kernel.")


class _Recorded(PR.record_function):
    """record_function that logs (name, args) of every span it opens."""
    opened: list = []

    def __enter__(self):
        type(self).opened.append((self.name, self.args))
        return super().__enter__()


def _animated_svao_small(width=48, height=32):
    from rtsdm_tpu_torch.mogwai import Renderer, run_script
    m = Renderer(width, height, device="cpu")
    run_script(str(ROOT / "scripts" / "SVAO_small.py"), m)
    m.loadScene("CornellBox")
    node = np.zeros(m.scene.num_triangles, np.int32)
    node[:8] = 1
    m.scene = dataclasses.replace(m.scene, node_id=torch.as_tensor(node))
    for g in m.graphs:
        g.set_scene(m.scene)
    m.animationController = AT.AnimationController(
        {1: AT.NodeTrack.oscillate((0.0, 1.0, 0.0), amplitude=0.5,
                                   period=1.0)})
    m.cameraPath = AT.CameraPath.orbit(center=(0.0, 1.0, 0.0), radius=3.5,
                                       height=0.5, duration=4.0)
    m.clock.play()
    return m


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A frame with the profiler off, then one with it on under
    torch.profiler: the spans each opened, the capture, and the traced
    frame's spans from its Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    m = _animated_svao_small()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "record_function", _Recorded)
        _Recorded.opened = []
        m.renderFrame()
        out["off_opened"] = list(_Recorded.opened)
        out["off_capture"] = m.profiler.capture()
        m.profiler.enabled = True
        out["frame"] = m.clock.frame
        _Recorded.opened = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            m.renderFrame()
        out["on_opened"] = list(_Recorded.opened)
    out["capture"] = m.profiler.capture()
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out["spans"] = [(e["name"][len(PREFIX):], float(e["ts"]),
                     float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("ph") == "X"
                    and e.get("name", "").startswith(PREFIX)]
    return out


def _paths(capture):
    def walk(node, prefix):
        for c in node["children"]:
            path = f"{prefix}/{c['name']}" if prefix else c["name"]
            yield path, c
            yield from walk(c, path)
    return dict(walk(capture, ""))


def test_a_traced_svao_frame_has_the_programs_spans(frames):
    names = {n for n, _, _ in frames["spans"]}
    for phase in ("phase1", "sd_map", "phase2"):
        assert f"renderFrame/SVAO/{phase}" in names
    assert "renderFrame/GBufferRaster/geometry.raster_bins" in names
    assert "renderFrame/SVAO/sd_map/StochasticDepthMap/geometry.sd_pack" \
        in names
    assert "renderFrame/SVAO/sd_map/StochasticDepthMap/sd_rays" in names
    # a wrapper's span directly under a pass
    assert any(n.count("/") == 2 and n.split("/")[2].startswith("kernel.")
               for n in names if n.startswith("renderFrame/"))
    top = [n for n in names if "/" not in n]
    assert sorted(top) == ["animate", "camera_path", "renderFrame"]


def test_the_spans_nest_as_the_capture_does(frames):
    """Each span lies inside one of its parent's, and the trace holds as
    many of each as the capture counts."""
    spans = frames["spans"]
    by_name = {}
    for n, s, e in spans:
        by_name.setdefault(n, []).append((s, e))
    for n, s, e in spans:
        if "/" in n:
            parent = n.rsplit("/", 1)[0]
            assert any(ps <= s and e <= pe
                       for ps, pe in by_name.get(parent, ())), n
    counts = {p: c["count"] for p, c in _paths(frames["capture"]).items()}
    assert {n: len(v) for n, v in by_name.items()} == counts


def test_geometry_and_kernel_spans_never_nest(frames):
    for path in _paths(frames["capture"]):
        layered = [p for p in path.split("/") if p.startswith(LAYERED)]
        assert len(layered) <= 1, path


def test_the_profiler_off_opens_no_span(frames):
    assert frames["off_opened"] == []
    assert frames["off_capture"]["children"] == []
    assert PR._active is None


def test_the_frame_scope_excludes_the_harness_step(frames):
    """renderFrame keeps its extent: animate and camera_path are its
    siblings and end before it starts; the top-level spans carry the
    frame index."""
    capture = frames["capture"]
    assert [c["name"] for c in capture["children"]] == [
        "animate", "camera_path", "renderFrame"]
    frame = [c for c in capture["children"] if c["name"] == "renderFrame"][0]
    assert not {"animate", "camera_path"} & {c["name"]
                                             for c in frame["children"]}
    iv = {n: (s, e) for n, s, e in frames["spans"] if "/" not in n}
    assert iv["animate"][1] <= iv["renderFrame"][0]
    assert iv["camera_path"][1] <= iv["renderFrame"][0]
    args = {n[len(PREFIX):]: a for n, a in frames["on_opened"]}
    assert args["renderFrame"] == args["animate"] == str(frames["frame"])
    assert args["renderFrame/SVAO"] is None


def test_a_disabled_scope_is_one_shared_object():
    off = PR.Profiler(enabled=False)
    assert off.event("x") is PR.NULL_SCOPE
    assert off.activate() is PR.NULL_SCOPE
    assert PR.profile_scope("x") is PR.NULL_SCOPE
    with off.activate():
        assert PR.profile_scope("x") is PR.NULL_SCOPE


def test_profile_scope_nests_under_the_active_profilers_open_scope():
    prof = PR.Profiler()
    with prof.activate():
        with prof.event("frame"):
            with PR.profile_scope("kernel.k"):
                pass
        with pytest.raises(ValueError):
            with prof.event("frame"), PR.profile_scope("geometry.g"):
                raise ValueError
    assert PR.profile_scope("x") is PR.NULL_SCOPE
    assert sorted(prof.flat_averages()) == ["frame", "frame/geometry.g",
                                            "frame/kernel.k"]
    assert prof._stack == [prof.root]


def test_the_divisor_1_sd_fetch_has_its_kernel_span(tmp_path):
    """At stochMapDivisor 1 (BASELINE config 3) phase 2's SD fetch is K11's
    wrapper: a traced frame holds its span, kernel.fetch_sd_strided, once a
    ring direction inside renderFrame/SVAO/phase2, and K4's not at all."""
    from torch.profiler import ProfilerActivity, profile
    m = _animated_svao_small()
    m.active_graph.get_pass("SVAO").cfg.update(stochMapDivisor=1,
                                               stochMapGuardBand=16)
    m.profiler.enabled = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.renderFrame()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"][len(PREFIX):]
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e.get("name", "").startswith(PREFIX)]
    phase2 = "renderFrame/SVAO/phase2"
    nd = m.active_graph.get_pass("SVAO").cfg["sampleCount"]
    assert names.count(f"{phase2}/kernel.fetch_sd_strided") == nd
    assert not [n for n in names if n.endswith("kernel.fetch_sd_packed")]
    assert _paths(m.profiler.capture())[
        f"{phase2}/kernel.fetch_sd_strided"]["count"] == nd


@pytest.mark.parametrize("divisor", [4, 1])
def test_the_phase2_resolve_has_its_kernel_span(tmp_path, divisor):
    """Phase 2's direction loop is K12's wrapper: a traced frame holds its
    span, kernel.svao_resolve, inside renderFrame/SVAO/phase2 once at
    stochMapDivisor 4 (K4 fetches the whole ring) and once a ring
    direction at divisor 1 (after each K11 fetch), beside the fetches'
    spans, never inside them."""
    from torch.profiler import ProfilerActivity, profile
    m = _animated_svao_small()
    svao = m.active_graph.get_pass("SVAO")
    if divisor == 1:
        svao.cfg.update(stochMapDivisor=1, stochMapGuardBand=16)
    m.profiler.enabled = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.renderFrame()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"][len(PREFIX):]
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e.get("name", "").startswith(PREFIX)]
    phase2 = "renderFrame/SVAO/phase2"
    want = 1 if divisor == 4 else svao.cfg["sampleCount"]
    assert [n for n in names if n.endswith("kernel.svao_resolve")] \
        == [f"{phase2}/kernel.svao_resolve"] * want
    fetch = "fetch_sd_packed" if divisor == 4 else "fetch_sd_strided"
    assert names.count(f"{phase2}/kernel.{fetch}") == (
        1 if divisor == 4 else want)
    assert _paths(m.profiler.capture())[
        f"{phase2}/kernel.svao_resolve"]["count"] == want


def _clear_table_caches():
    from rtsdm_tpu_torch.ops import ao as A
    from rtsdm_tpu_torch.passes import svao_shift as PH
    from rtsdm_tpu_torch.utils import device as D
    for cached in (D._constant, A._dir_params, PH._class_consts):
        cached.cache_clear()


def test_svao_builds_its_tables_in_the_first_frame_only():
    """SVAO's constant tables (the SD pass's ray jitter table, the camera's
    and the phases' constants, the per-direction tables) are made on the
    device on a cache miss, each miss under the span tables.svao: the
    first frame opens it inside SVAO, and the next frame neither opens it
    nor makes a tensor from host values anywhere in SVAO (on a GPU each
    would be a blocking copy)."""
    from unittest import mock

    from rtsdm_tpu_torch.passes.svao import SVAO
    _clear_table_caches()
    m = _animated_svao_small()
    m.profiler.enabled = True
    m.renderFrame()
    first = [p for p in _paths(m.profiler.capture())
             if p.endswith("/tables.svao")]
    assert first and all(p.startswith("renderFrame/SVAO/") for p in first)
    assert "renderFrame/SVAO/sd_map/StochasticDepthMap/sd_rays/tables.svao" \
        in first

    made, in_svao = [], []

    def watched(name, fn):
        def call(*a, **k):
            if in_svao:
                made.append(name)
            return fn(*a, **k)
        return call

    real = SVAO.execute

    def execute(self, *a, **k):
        in_svao.append(True)
        try:
            return real(self, *a, **k)
        finally:
            in_svao.pop()

    m.profiler.reset()
    with mock.patch.multiple(torch, **{f: watched(f, getattr(torch, f))
                                       for f in ("tensor", "as_tensor",
                                                 "from_numpy")}), \
            mock.patch.object(torch.Tensor, "new_tensor", watched(
                "new_tensor", torch.Tensor.new_tensor)), \
            mock.patch.object(SVAO, "execute", execute):
        m.renderFrame()
    assert not [p for p in _paths(m.profiler.capture())
                if p.endswith("tables.svao")]
    assert made == []
