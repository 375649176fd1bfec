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
