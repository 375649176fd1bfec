"""The cell suntemple_1080p_rastersd.still (BASELINE config 2's raster
stochastic-depth map at config 3's full-resolution still frame) on the
CPU: the reference's K9 (reference/port/ops/ref_raster_sd.py, its own cull)
returns the slots of the program's plain K9 bit for bit; a tiny copy of
the cell comes out correct against the reference and not correct under
each fault of test_perf_faults, nor with the program's SD map emptied;
raster_sd_roofline reads its kernel, leaving raster_roofline (K1) as it
reads without K9's entries; and sd_fetch_roofline counts K11's reads of
the raster map, which has no SD guard band."""
import json
import time

import perfutil
import pytest
import torch
from test_perf_faults import FAULTS
from test_perf_sdtrace import POSES, _scene

from harness import (cell, discover, roofline, roofline_raster_sd,
                     roofline_sd_fetch)
from reference.port.ops import ref_raster, ref_raster_sd
from reference.port.scene.camera import Camera

torch.set_num_threads(2)

CELL = "suntemple_1080p_rastersd.still"
W, H, K, ALPHA = 120, 72, 4, 0.375


def _pose(pose):
    scene = _scene()
    base = scene.camera
    pos, tgt = POSES[pose]
    cam = Camera.create(position=pos, target=tgt,
                        focal_length=float(base.focal_length),
                        frame_height=float(base.frame_height), aspect=W / H,
                        near_z=float(base.near_z), far_z=float(base.far_z),
                        device="cpu")
    return scene.with_camera(cam)


@pytest.mark.parametrize("interval", [True, False])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_reference_raster_sd_equals_the_program_plain_k9(pose, interval):
    """Behind the scene's first layer (the reference's own raster), with a
    ray interval that leaves out some fragments (ray_min 0 on every third
    row, ray_max 0 on every seventh column) and without one."""
    from rtsdm_tpu_torch.ops import raster as prog_raster
    from rtsdm_tpu_torch.ops import raster_cuda as prog_rc
    scene = _pose(pose)
    cam = scene.camera
    vp = cam.view_proj_no_jitter
    first = cam.linearize_depth(ref_raster.rasterize_reference(
        vp, scene.positions, width=W, height=H)["depth"])
    rmin = rmax = None
    if interval:
        g = torch.Generator().manual_seed(3)
        rmin = first * (0.5 + 0.5 * torch.rand(H, W, generator=g))
        rmin[::3] = 0.0
        rmax = first + 0.5 + 20.0 * torch.rand(H, W, generator=g)
        rmax[:, ::7] = 0.0
    record = ref_raster.record = []
    try:
        ref = ref_raster_sd.raster_stochastic_reference(
            vp, scene.positions, cam.far_z, width=W, height=H, k=K,
            alpha=ALPHA, first_depth=first, ray_min=rmin, ray_max=rmax)
    finally:
        ref_raster.record = None
    (chunks, _, lists, counts, nby, nbx), _ = prog_raster._binned_chunks(
        vp, scene.positions, W, H, 0.0, 0.0, "back")
    planes = prog_raster.stochastic_planes(W, H, first, rmin, rmax, "cpu")
    slots = prog_rc.raster_stochastic_blocks_plain(
        chunks, None, lists, counts, nby, nbx, *planes, K, ALPHA)
    prog = prog_raster.stochastic_depths(slots, W, H, cam.far_z)
    filled = ref < cam.far_z
    assert 0.02 < float(filled.float().mean()) < 0.98
    assert torch.equal(ref, prog)
    (rec,) = record
    assert (rec["triangles"], rec["pixels"], rec["coverages"]) == (0, 0, 0)
    assert rec["sd_texels"] == W * H and rec["k"] == K
    assert rec["sd_triangles"] == scene.positions.shape[0]
    assert 0 < rec["sd_inserted"] <= rec["sd_coverages"]
    assert rec["sd_inserted"] >= int(filled.any(-1).sum())


def _tiny(tmp_path):
    """perfutil's tiny copy of the cell, its SVAO radius widened from the
    graph's 0.2 to 2: in the tiny town at 48x32 phase 1 then asks the SD
    map for samples that fragments behind the first layer fill (1,200
    inserted at frame 2, none at 0.2), as the full town's foliage does at
    the cell's size."""
    root, bench = perfutil.tiny_cell(tmp_path, CELL)
    path = root / "configs" / f"{CELL.split('.')[0]}.json"
    cfg = json.loads(path.read_text())
    cfg["pass_overrides"]["SVAO"]["radius"] = 2.0
    path.write_text(json.dumps(cfg))
    return root, bench


def _run(tmp_path):
    root, bench = _tiny(tmp_path)
    return cell.run(CELL, bench, 2718281828, 0.2, False,
                    time.perf_counter(), device="cpu", root=root)


def test_tiny_copy_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == 10


def _sd_map_emptied(monkeypatch):
    """The program's raster SD pass hands on a map with every slot far."""
    from rtsdm_tpu_torch.passes.stochastic_depth import StochasticDepthMap
    orig = StochasticDepthMap.execute

    def execute(self, ctx, inputs, state=None):
        out, ns = orig(self, ctx, inputs, state)
        return {"stochasticDepth": torch.ones_like(
            out["stochasticDepth"])}, ns
    monkeypatch.setattr(StochasticDepthMap, "execute", execute)


RASTER_SD_FAULTS = dict(FAULTS, sd_map_emptied=_sd_map_emptied)


@pytest.mark.parametrize("fault", sorted(RASTER_SD_FAULTS))
def test_tiny_copy_with_a_fault_is_not_correct(tmp_path, monkeypatch, fault):
    RASTER_SD_FAULTS[fault](monkeypatch)
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["failed"] > 0


def test_the_reference_frame_records_k9_beside_k1(tmp_path):
    """The tiny copy's compared frame: the reference's raster record holds
    K1's calls (the G-buffer's and the lighting's) and one K9 call over
    the whole frame with the guard band (no SD guard band at divisor 1)."""
    root, _ = _tiny(tmp_path)
    wl = discover.load_json("workloads", CELL, root)
    cfg = discover.load_json("configs", wl["config"], root)
    arrays, camera = cell.inputs(cfg, wl, 5)
    _, counts, _ = cell.reference_frame(cfg, wl, arrays, camera, 2, None,
                                        "cpu")
    sd = roofline_raster_sd.raster_sd_calls(counts["raster"])
    assert len(sd) == 1 and len(counts["raster"]) == 3
    assert sd[0]["sd_texels"] == (cfg["width"] + 128) * (cfg["height"] + 128)
    assert sd[0]["sd_inserted"] > 0


def _summary(kernels: dict, frames: int = 4) -> dict:
    return {"frames": frames, "window_s": 1.0, "busy_s": 0.5,
            "activities": 10, "kernel_s": kernels}


K1_CALL = {"triangles": 323202, "pixels": 2048 * 1208,
           "coverages": 2_000_000_000, "floored": False}
K9_CALL = {"triangles": 0, "pixels": 0, "coverages": 0,
           "sd_triangles": 323202, "sd_texels": 2048 * 1208,
           "sd_coverages": 1_000_000_000, "sd_inserted": 50_000_000, "k": 4}
TRACE = _summary({
    "void (anonymous namespace)::raster_blocks_kernel<false>(float const*)":
        0.008,
    "void (anonymous namespace)::raster_sd_kernel<4>(float const*, float "
    "const*, int const*)": 0.004})


def test_raster_sd_roofline_reads_a_synthetic_summary():
    ops = 1_000_000_000 * 24 + 50_000_000 * 4
    nbytes = 323202 * 36 + 2048 * 1208 * (12 + 16)
    bound = max(ops / roofline.PEAK_FLOPS, nbytes / roofline.PEAK_BYTES_S)
    assert bound == ops / roofline.PEAK_FLOPS      # bound by operations
    reader = discover.load_metric("raster_sd_roofline")
    r = {"trace": TRACE, "reference": {"raster": [K1_CALL, K9_CALL]}}
    assert reader.read(r) == pytest.approx(100.0 * bound / 0.001)
    # nothing to read: no K9 kernel, no K9 call, no trace
    k1_only = _summary({"raster_blocks_kernel<false>": 0.008})
    assert reader.read(dict(r, trace=k1_only)) is None
    assert reader.read(dict(r, reference={"raster": [K1_CALL]})) is None
    assert reader.read(dict(r, trace=None)) is None


def test_raster_roofline_reads_k1_alone_beside_k9s_entries():
    reader = discover.load_metric("raster_roofline")
    alone = reader.read({"trace": TRACE, "reference": {"raster": [K1_CALL]}})
    both = reader.read({"trace": TRACE,
                        "reference": {"raster": [K1_CALL, K9_CALL]}})
    assert alone is not None and both == alone
    assert roofline.raster_bound_s([K9_CALL]) == 0.0


def test_sd_fetch_roofline_counts_the_raster_map_without_a_guard_band():
    """K11's bytes a frame at the cell: the 8 directions' values of config
    3's [16, 4, 302, 512] fetch written once and the 2048x1208 x 4 map
    (the frame with SVAO_small.py's 64 px guard band, no SD guard band)
    read once, 39.6 MB where config 3's 3072x2232 map is 109.7 MB."""
    bench = discover.load_benchmark(discover.HERE.parent / "BENCHMARK.json")
    entry = next(e for e in bench["per_layer"]
                 if e["name"] == "sd_fetch_roofline")
    assert CELL in entry["workloads"]
    cfg = discover.load_json("configs", CELL.split(".")[0], discover.HERE)
    assert cfg["pass_overrides"]["SVAO"]["stochMapGuardBand"] == 0
    written = 8 * 16 * 4 * 302 * 512 * 4
    assert roofline_sd_fetch.sd_fetch_bytes(cfg) == \
        written + 2048 * 1208 * 4 * 4
