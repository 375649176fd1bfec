"""The metric arithmetic on hand-built cases."""
import math

import perfutil  # noqa: F401  (import paths)
import pytest
import torch

from harness import roofline, stats, trace


def test_window_rate_counts_every_frame():
    assert stats.window_rate_ms(30.0, 120) == pytest.approx(250.0)
    with pytest.raises(ValueError):
        stats.window_rate_ms(30.0, 0)


@pytest.mark.parametrize("q,expect", [(90, 9.1), (50, 5.5), (0, 1.0),
                                      (100, 10.0)])
def test_percentile_over_all_frames(q, expect):
    assert stats.percentile(range(1, 11), q) == pytest.approx(expect)


def test_idle_union_merges_overlaps_and_clips():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    g = stats.gaps(iv, 0.0, 10.0)
    assert g[0] == (4.0, 9.0) and g[1] == (2.0, 3.0)
    assert stats.idle_share_pct(5.0, 10.0) == pytest.approx(50.0)


def test_mse_and_shape_mismatch():
    a = torch.zeros(4, 4)
    b = torch.full((4, 4), 0.5)
    assert stats.mse(a, b) == pytest.approx(0.25)
    assert math.isinf(stats.mse(a, torch.zeros(3, 4)))
    assert math.isnan(stats.mse(a, torch.full((4, 4), float("nan"))))


def test_roofline_counts_are_max_of_two_bounds():
    # 1e9 coverages: 24e9 ops / 67e12 = 3.58e-4 s; bytes 36e6 + 16e6
    calls = [{"coverages": 10**9, "triangles": 10**6, "pixels": 10**6}]
    assert roofline.raster_bound_s(calls) == pytest.approx(24e9 / 67e12)
    calls = [{"coverages": 0, "triangles": 10**6, "pixels": 10**6}]
    assert roofline.raster_bound_s(calls) == pytest.approx(52e6 / 3.35e12)
    hits = [{"pairs": 10**8, "triangles": 10**6, "rays": 10**6}]
    assert roofline.any_hit_bound_s(hits) == pytest.approx(41e8 / 67e12)


def test_trace_summary_of_a_hand_built_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.FRAME_MARK,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": trace.FRAME_MARK,
           "ts": 1000, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "raster_blocks_kernel",
           "ts": 100, "dur": 300},
          {"ph": "X", "cat": "kernel", "name": "raster_blocks_kernel",
           "ts": 1100, "dur": 500},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 300, "dur": 200},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero",
           "ts": 500, "dur": 600}]
    s = trace.summarize({"traceEvents": ev})
    assert s["frames"] == 2 and s["activities"] == 3
    assert s["window_s"] == pytest.approx(2e-3)
    assert s["busy_s"] == pytest.approx(9e-4)
    assert trace.kernel_seconds(s, "raster_blocks") == pytest.approx(8e-4)
    assert trace.kernel_seconds(s, "any_hit") is None
    assert s["idle_gaps"][0][0] == "aten::nonzero"
    assert s["idle_gaps"][0][1] == pytest.approx(6e-4)
