"""The readers of the program's spans (harness/spans.py) on a synthetic
Chrome trace and capture, and span_report's traced run of a tiny cell on
the CPU, whose other readings stay what cell.run gives without it."""
import time

import perfutil
import pytest
import torch

from harness import cell, drive, spans, trace

import span_report

torch.set_num_threads(2)

US = 1e-6


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    """One frame mark over [-5, 100] us: the harness step, then a frame of
    GBufferRaster and SVAO (phase1, sd_map, phase2); four device
    activities launched from inside the spans, one outside the marks."""
    ev = [_x(trace.FRAME_MARK, "user_annotation", -5, 105)]
    for name, s, e in (("animate", 0, 10), ("renderFrame", 10, 100),
                       ("renderFrame/GBufferRaster", 10, 30),
                       ("renderFrame/SVAO", 30, 90),
                       ("renderFrame/SVAO/phase1", 30, 50),
                       ("renderFrame/SVAO/sd_map", 50, 70),
                       ("renderFrame/SVAO/phase2", 70, 90)):
        ev.append(_x("rtsdm/" + name, "user_annotation", s, e - s))
    for corr, launch, cat, s, e in ((1, 12, "kernel", 15, 35),
                                    (2, 32, "kernel", 40, 45),
                                    (3, 55, "kernel", 60, 95),
                                    (4, 91, "gpu_memset", 96, 98),
                                    (5, 150, "kernel", 200, 210)):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", launch, 1,
                     correlation=corr))
        ev.append(_x(f"k{corr}", cat, s, e - s, correlation=corr))
    ev.append(_x("aten::add", "cpu_op", 40, 3))
    return {"traceEvents": ev}


def test_idle_is_put_down_to_the_innermost_span():
    got = spans.attribute(_trace())
    assert got["frames"] == 1
    assert got["idle_s"] == pytest.approx(43 * US)
    assert got["idle_by_span"] == pytest.approx({
        "animate": 10 * US, "renderFrame/GBufferRaster": 5 * US,
        "renderFrame/SVAO/phase1": 10 * US,
        "renderFrame/SVAO/sd_map": 10 * US, "renderFrame": 3 * US})
    assert got["no_span_s"] == pytest.approx(5 * US)
    summary = spans.idle_by_span(got)
    assert summary["no_span_pct"] == pytest.approx(100 * 5 / 43)
    assert list(summary["spans_ms"])[0] in ("animate",
                                            "renderFrame/SVAO/phase1",
                                            "renderFrame/SVAO/sd_map")


def test_idle_overlapping_a_spans_host_interval():
    idle = spans.attribute(_trace())["span_idle_s"]
    assert idle["renderFrame/GBufferRaster"] == pytest.approx(5 * US)
    assert idle["renderFrame/SVAO"] == pytest.approx(20 * US)
    assert idle["renderFrame"] == pytest.approx(28 * US)
    assert idle["renderFrame/SVAO/phase2"] == 0.0


def test_activities_by_the_correlation_of_their_launch():
    got = spans.attribute(_trace())
    assert got["activities"] == 4 and got["launched"] == 4
    acts = got["span_activities"]
    assert acts["renderFrame/SVAO"] == 2
    assert acts["renderFrame/GBufferRaster"] == 1
    assert acts["renderFrame"] == 4
    assert acts["renderFrame/SVAO/phase2"] == 0
    assert spans.trace_metrics(got) == pytest.approx({
        "idle_ms.GBufferRaster": 0.005, "idle_ms.SVAO": 0.020,
        "activities.SVAO": 2.0})
    ranked = spans.device_by_span(got)
    assert [r[:2] for r in ranked] == [
        ["renderFrame/SVAO/sd_map", "k3"], ["renderFrame/GBufferRaster", "k1"],
        ["renderFrame/SVAO/phase1", "k2"], ["renderFrame", "k4"]]
    assert [r[2] for r in ranked] == pytest.approx([0.035, 0.020, 0.005,
                                                    0.002])


def _n(name, total, count=2, children=()):
    return {"name": name, "count": count, "total_ms": total,
            "children": list(children)}


CAPTURE = _n("/", 0.0, 0, [
    _n("animate", 4.0), _n("camera_path", 2.0),
    _n("renderFrame", 200.0, children=[
        _n("GBufferRaster", 30.0, children=[
            _n("geometry.raster_bins", 6.0), _n("kernel.raster_blocks", 2.0)]),
        _n("SVAO", 100.0, children=[
            _n("phase1", 30.0),
            _n("sd_map", 40.0, children=[
                _n("StochasticDepthMap", 36.0, children=[
                    _n("geometry.sd_pack", 8.0),
                    _n("kernel.sd_trace_blocks", 4.0, children=[
                        _n("kernel.sd_keys", 1.0)])])]),
            _n("phase2", 20.0, children=[
                _n("kernel.fetch_sd_packed", 2.0)])])])])


def test_span_metrics_sum_the_outermost_layer_nodes_per_frame():
    assert spans.span_metrics(CAPTURE) == pytest.approx({
        "span_ms.harness": 3.0, "span_ms.SVAO.phase1": 15.0,
        "span_ms.SVAO.sd_map": 20.0, "span_ms.SVAO.phase2": 10.0,
        "span_ms.geometry": 7.0, "span_ms.wrappers": 4.0})
    assert spans.spans_per_frame(CAPTURE) == 15.0   # 15 scopes, twice
    table = spans.per_frame_ms(CAPTURE)
    assert len(table) == 15 and table["renderFrame/SVAO/phase1"] == 15.0


def test_the_traced_frames_are_taken_out_of_the_capture():
    before = _n("/", 0.0, 0, [_n("renderFrame", 20.0, count=1)])
    after = _n("/", 0.0, 0, [_n("renderFrame", 120.0, count=2, children=[
        _n("SVAO", 70.0, count=1, children=[_n("phase1", 50.0, count=1)])])])
    got = spans.less(CAPTURE, after, before)
    assert spans.frames(got) == 1
    assert spans.node(got, "renderFrame")["total_ms"] == pytest.approx(100.0)
    assert spans.node(got, "renderFrame/SVAO/phase1")["total_ms"] == \
        pytest.approx(-20.0)
    assert spans.node(got, "animate") == spans.node(CAPTURE, "animate")


def test_a_program_without_the_spans_gives_no_number():
    bare = _n("/", 0.0, 0, [_n("renderFrame", 200.0)])
    assert spans.span_metrics(bare) == {}
    assert spans.span_metrics(None) == {}
    ev = [e for e in _trace()["traceEvents"]
          if not e["name"].startswith("rtsdm/")]
    got = spans.attribute({"traceEvents": ev})
    assert spans.trace_metrics(got) == {}
    assert got["no_span_s"] == pytest.approx(got["idle_s"])
    assert spans.trace_metrics(spans.attribute({"traceEvents": []})) == {}


def _tiny_run(tmp_path, name):
    root, bench = perfutil.tiny_cell(tmp_path, name)
    return cell.run(name, bench, 7, 8.0, True, time.perf_counter(),
                    device="cpu", root=root)


@pytest.mark.parametrize("name", perfutil.CELLS)
def test_span_report_leaves_every_reading_as_it_was(tmp_path, name):
    plain = _tiny_run(tmp_path / "plain", name)
    def seams():
        return (drive.Driver.build, trace.Profiled.__enter__,
                trace.Profiled.__exit__, trace.summarize, cell.run_program,
                cell.run)
    before = seams()
    with span_report.reading_spans():
        got = _tiny_run(tmp_path / "spans", name)
    assert seams() == before
    added = {"spans", "idle_by_span", "device_by_span", "span_run"}
    assert set(got) == set(plain) | added
    assert set(got["metrics"]) == set(plain["metrics"])
    assert got["correct"] and plain["correct"]
    assert {k: c["value"] for k, c in got["checks"].items()} == \
        {k: c["value"] for k, c in plain["checks"].items()}
    metrics = got["spans"]
    for key in ("span_ms.harness", "span_ms.SVAO.phase1",
                "span_ms.SVAO.sd_map", "span_ms.SVAO.phase2",
                "span_ms.geometry", "span_ms.wrappers", "idle_ms.SVAO",
                "idle_ms.GBufferRaster", "activities.SVAO"):
        assert key in metrics and metrics[key] >= 0.0, key
    assert metrics["span_ms.geometry"] > 0 and metrics["span_ms.wrappers"] > 0
    window = got["span_run"]
    assert window["spans_per_frame"] > 10
    # the two traced frames from the compared one, where the window has them
    j = cell.compare_frames(7, {"compare_frames": [2, 4]})
    assert got["frames"] >= j + 2
    assert window["frames"] == got["frames"] - 2
    assert 0.5 < window["svao_phase_share"] <= 1.0
    assert got["idle_by_span"]["frames"] == 2
