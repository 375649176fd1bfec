"""The cell suntemple_1080p_div1.still (BASELINE config 3: the SD map at
full resolution) on the CPU: a tiny copy of it comes out correct against
the frozen reference and not correct under each fault of
test_perf_faults, the still view's Halton jitter keeping a stale frame
apart from the compared one; and its two per-layer readers. The tiny copy
keeps the configuration's 512-pixel SD guard band (about 25 s a run)."""
import time

import perfutil
import pytest
from test_perf_faults import FAULTS

from harness import cell, discover, roofline, roofline_sd_fetch

CELL = "suntemple_1080p_div1.still"


def _run(tmp_path):
    root, bench = perfutil.tiny_cell(tmp_path, CELL)
    return cell.run(CELL, bench, 2718281828, 0.2, False,
                    time.perf_counter(), device="cpu", root=root)


def test_tiny_copy_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == 10


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tiny_copy_with_a_fault_is_not_correct(tmp_path, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["failed"] > 0


def _summary(kernels: dict, frames: int = 4) -> dict:
    return {"frames": frames, "window_s": 1.0, "busy_s": 0.5,
            "activities": 10, "kernel_s": kernels}


def test_readers_return_none_without_their_kernels():
    cfg = perfutil.load("configs", "suntemple_1080p_div1")
    other = _summary({"void (anonymous namespace)::fetch_sd_packed_kernel"
                      "<4>(float const*)": 0.001,
                      "sd_trace_resident_kernel<4, true>": 0.002})
    for name in ("sd_trace_device_ms", "sd_fetch_roofline"):
        reader = discover.load_metric(name)
        assert reader.read({"trace": other, "config": cfg}) is None
        assert reader.read({"trace": None, "config": cfg}) is None
        assert reader.read({"trace": {"frames": 0}, "config": cfg}) is None


def test_readers_read_their_kernels():
    cfg = perfutil.load("configs", "suntemple_1080p_div1")
    tr = _summary({"void (anonymous namespace)::sd_trace_kernel<4, true>"
                   "(Params)": 0.064,
                   "void (anonymous namespace)::fetch_sd_strided_kernel<4>"
                   "(float const*)": 0.002})
    r = {"trace": tr, "config": cfg}
    assert discover.load_metric("sd_trace_device_ms").read(r) == \
        pytest.approx(16.0)
    want = 100.0 * 426_377_216 / roofline.PEAK_BYTES_S / 0.0005
    assert discover.load_metric("sd_fetch_roofline").read(r) == \
        pytest.approx(want)
    # at divisor 4 (K4's configurations) there is no such fetch to count
    emerald = perfutil.load("configs", "emerald_720p")
    assert discover.load_metric("sd_fetch_roofline").read(
        {"trace": tr, "config": emerald}) is None


def test_sd_fetch_bytes_at_config_3_are_the_docstring_figure():
    cfg = perfutil.load("configs", "suntemple_1080p_div1")
    written = 8 * 16 * 4 * 302 * 512 * 4
    read = 3072 * 2232 * 4 * 4
    assert (written, read) == (316_669_952, 109_707_264)
    assert roofline_sd_fetch.sd_fetch_bytes(cfg) == written + read \
        == 426_377_216
    assert "426,377,216 bytes, 0.1273 ms" in roofline_sd_fetch.__doc__
    assert roofline_sd_fetch.sd_fetch_bound_s(cfg) * 1e3 == \
        pytest.approx(0.1273, abs=5e-5)
