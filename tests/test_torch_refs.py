"""The mid-size references of tests/torch_refs/ (the JAX package's renders
of scripts/SVAO_small.py, scripts/HBAO.py, BASELINE config 2,
scripts/SVAO.py, scripts/SVAO.py under DualDepth, scripts/
SVAO_quarter.py, scripts/SVAO_depth.py and BASELINE config 5's animation
above every golden's size, made by tests/torch_refs/make_refs.py): they
load, hold finite float32 images of the size they record, with an MSE
bound in chip_smoke.py for each output, and record the settings
chip_smoke.py reads from them to render the port when it holds the card
against them, the JAX package's accelerator branches included (hazards f,
k, l and m of ROADMAP.md); the raster channels stored beside each of them
for the substituted holds are the ones their settings list, whole, one
set a frame where they render more than one. Nothing is rendered here.

This file imports neither jax nor rtsdm_tpu.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# each reference's AO output (its first channel lies in [0, 1])
AO = {"SVAO_small": "AmbientOcclusion.out", "HBAO": "Ambient.out",
      "SVAO_rasterSD": "AmbientOcclusion.out", "SVAO_full": "AmbientRef.out",
      "SVAO_quarter": "AmbientOcclusion.out", "SVAO_dual": "AmbientRef.out",
      "SVAO_depth": "Ambient.out", "SVAO_anim": "AmbientOcclusion.out"}
# the raster passes of each script (all capped)
RASTERS = {"scripts/SVAO_quarter.py": ("GBufferRaster", "ForwardLighting"),
           "scripts/SVAO_depth.py": ("GBufferRaster", "DepthPeeling")}
# what make_refs.py records of its render beside the settings it rendered
RESULTS = ("seconds", "raster_overflow", "overflow_at_256", "overflow")


def settings_of(name: str) -> dict:
    """The settings make_refs.py rendered reference `name` with."""
    settings, ref = chip_smoke.mid_ref(name)
    ref.close()
    return {k: v for k, v in settings.items() if k not in RESULTS}


@pytest.fixture(scope="module", params=sorted(chip_smoke.MID_REFS))
def ref(request):
    with np.load(chip_smoke.mid_ref_file(request.param)) as f:
        return request.param, {k: f[k] for k in f.files}


def test_mid_size_refs_record_what_chip_smoke_renders(ref):
    """The settings chip_smoke.py renders the port with are the ones the
    file records: its name agrees with them, each output has an MSE bound,
    the images are well-formed and no raster dropped a triangle."""
    name, ref = ref
    settings = json.loads(str(ref["settings"]))
    bound = chip_smoke.MID_REFS[name]
    assert chip_smoke.mid_ref_file(name).name == (
        f"{name}.{settings['scene'].replace('@', '_')}.{settings['width']}x"
        f"{settings['height']}.f{settings['frame']}.npz")
    assert set(bound) == set(settings["outputs"])
    assert set(ref) == set(settings["outputs"]) | {"settings"}
    assert settings["width"] * settings["height"] > 128 * 128  # > goldens
    # the JAX package's raster dropped no triangle in any tile, in the
    # G-buffer raster and (where recorded) in every raster pass that ran
    assert settings["overflow"] == 0
    assert not any(settings.get("raster_overflow", {}).values())
    for out in settings["outputs"]:
        img = ref[out]
        assert img.dtype == np.float32
        assert img.shape[:2] == (settings["height"], settings["width"])
        assert img.shape[2] in (3, 4)
        assert np.isfinite(img).all()
    ao = ref[AO[name]][..., 0]
    assert 0.0 <= ao.min() < 0.9 and ao.max() <= 1.0


def test_mid_size_refs_take_the_accelerator_branches():
    """HBAO's reference shifts (hazard l), config 2's rasters its SD map
    through the Pallas kernel (hazard m) and the graphs with a ray-traced
    SD map trace it through the Pallas kernels with XLA's fused
    multiply-adds off (hazard q), and config 2's SVAO reads its SD map
    packed to 16 bits (hazard r), as the port does on the card; every
    reference takes the accelerator's shadows (hazard k) and raster caps
    (hazard f); config 2 differs from SVAO_small.py only there and in its
    SD raster, which it stores for its substituted hold."""
    refs = {name: settings_of(name) for name in chip_smoke.MID_REFS}
    hbao, sd = refs["HBAO"], refs["SVAO_rasterSD"]
    assert hbao["script"] == "scripts/HBAO.py"
    assert hbao["pass_overrides"]["HBAO"] == {"samplingMode": "Shift"}
    assert sd["pass_overrides"]["SVAO"] == {"stochasticDepthImpl": "Raster"}
    assert sd["pass_overrides"]["SVAO"] == \
        chip_smoke.CONFIGS["config2"][4]["SVAO"]
    assert "raster_stochastic_pallas" in sd["raster_sd"]
    assert "fetch_sd_packed" in sd["fused_fetch"]
    base = refs["SVAO_small"]
    differ = ("raster_sd", "ray_sd", "xla_flags", "fused_fetch",
              "substituted")
    assert {k: v for k, v in sd.items() if k not in differ} == dict(
        {k: v for k, v in base.items() if k not in differ},
        pass_overrides={**base["pass_overrides"],
                        "SVAO": sd["pass_overrides"]["SVAO"]})
    assert sd["substituted"] == base["substituted"] + [
        "StochasticDepthMap.stochasticDepth"]
    for name in ("SVAO_small", "SVAO_full", "SVAO_dual", "SVAO_quarter",
                 "SVAO_anim"):
        settings = refs[name]
        assert "sd_trace_pallas" in settings["ray_sd"], name
        assert settings["xla_flags"] == "--xla_cpu_max_isa=AVX", name
    for name in ("HBAO", "SVAO_rasterSD", "SVAO_depth"):
        assert not {"ray_sd", "xla_flags"} & set(refs[name]), name
    for settings in refs.values():
        # scripts/SVAO_depth.py has no RayShadow (and no ForwardLighting),
        # scripts/SVAO_quarter.py no DepthPeeling pass
        if settings["script"] != "scripts/SVAO_depth.py":
            assert "any_hit_pallas" in settings["shadows"]
        else:
            assert "shadows" not in settings
        rasters = RASTERS.get(settings["script"], (
            "GBufferRaster", "ForwardLighting", "DepthPeeling"))
        for p in rasters:
            assert settings["pass_overrides"][p] == {"maxPerTile": 4096}


def test_svao_full_ref_records_four_raster_caps_and_its_outputs():
    """scripts/SVAO.py's reference differs from SVAO_small.py's only in the
    script, its kept outputs (DiffuseDLSS.output, a pass-through stub, left
    out and said so), and its fourth raster pass, DepthPass, capped as the
    others (hazard f); the file records that the graph ran only the
    G-buffer and ForwardLighting rasters, neither overflowing, and the
    accelerator branches chip_smoke.py takes."""
    full, bound = settings_of("SVAO_full"), chip_smoke.MID_REFS["SVAO_full"]
    base = settings_of("SVAO_small")
    assert full["script"] == "scripts/SVAO.py"
    assert full["pass_overrides"] == dict(
        base["pass_overrides"], DepthPass={"maxPerTile": 4096})
    assert list(full["left_out"]) == ["DiffuseDLSS.output"]
    assert "DiffuseDLSS.output" not in full["outputs"] + list(bound)
    differ = ("script", "outputs", "pass_overrides", "left_out")
    assert {k: v for k, v in full.items() if k not in differ} == {
        k: v for k, v in base.items() if k not in differ}
    assert set(chip_smoke.SVAO_FULL_OUTPUTS) == set(full["outputs"]) | set(
        full["left_out"])
    with np.load(chip_smoke.mid_ref_file("SVAO_full")) as f:
        settings = json.loads(str(f["settings"]))
    assert settings["raster_overflow"] == {"ForwardLighting": 0,
                                           "GBufferRaster": 0}


def test_quarter_and_dual_refs_record_their_graphs():
    """BASELINE config 4's graph (scripts/SVAO_quarter.py: its two outputs,
    its two raster passes capped and neither overflowing) and scripts/
    SVAO.py with SVAO's primaryDepthMode set to DualDepth after the build
    (SVAO_full's settings but that override and one kept output; its
    DepthPeeling raster runs, capped, and overflows nothing)."""
    quarter, dual, full = (settings_of(n) for n in ("SVAO_quarter",
                                                    "SVAO_dual",
                                                    "SVAO_full"))
    assert quarter["script"] == "scripts/SVAO_quarter.py"
    assert set(quarter["outputs"]) == {"AmbientOcclusion.out",
                                       "ShadedTAA.colorOut"}
    assert dual["pass_overrides"] == dict(
        full["pass_overrides"], SVAO={"primaryDepthMode": "DualDepth"})
    assert dual["outputs"] == ["AmbientRef.out"]
    assert set(full["outputs"]) - set(dual["outputs"]) <= set(
        dual["left_out"])
    for name, ran in (("SVAO_quarter", {"GBufferRaster", "ForwardLighting"}),
                      ("SVAO_dual", {"GBufferRaster", "ForwardLighting",
                                     "DepthPeeling"})):
        with np.load(chip_smoke.mid_ref_file(name)) as f:
            settings = json.loads(str(f["settings"]))
        assert settings["raster_overflow"] == dict.fromkeys(ran, 0)


def test_svao_depth_ref_records_frame_one_of_two():
    """scripts/SVAO_depth.py's reference keeps frame 1 of two (so that
    TemporalDepthPeel holds frame 0's layer), both outputs, its two
    rasters capped and overflowing nothing; the JAX package ran no
    accelerator branch (the graph has no RayShadow and no raster SD)."""
    depth = settings_of("SVAO_depth")
    bound = chip_smoke.MID_REFS["SVAO_depth"]
    assert (depth["frames"], depth["frame"]) == (2, 1)
    assert depth["outputs"] == ["Ambient.out", "AmbientRef.out"]
    assert set(bound) == set(depth["outputs"])
    assert all(isinstance(b, float) and b > 0 for b in bound.values())
    with np.load(chip_smoke.mid_ref_file("SVAO_depth")) as f:
        settings = json.loads(str(f["settings"]))
    assert settings["raster_overflow"] == {"GBufferRaster": 0,
                                           "DepthPeeling": 0}
    assert "raster_sd" not in settings and "shadows" not in settings


def test_every_ref_has_a_substituted_hold():
    """Every reference stores the raster channels its AO reads, and
    chip_smoke.py holds each AO output it keeps with them substituted
    (the shaded outputs read ForwardLighting's own raster)."""
    assert set(chip_smoke.MID_SUBSTITUTED_BOUND) == set(chip_smoke.MID_REFS)
    for name in chip_smoke.MID_REFS:
        ao = {o for o in settings_of(name)["outputs"]
              if o.startswith(("AmbientOcclusion", "Ambient."))
              or o in ("AmbientRef.out", "AmbientTAA.colorOut")}
        assert set(chip_smoke.MID_SUBSTITUTED_BOUND[name]) == ao, name


@pytest.mark.parametrize("name", sorted(chip_smoke.MID_SUBSTITUTED_BOUND))
def test_substituted_rasters_stored_beside_their_refs(name):
    """The JAX package's raster channels that chip_smoke.py substitutes
    for the port's (<ref>.rasters.npz): those the reference's settings
    list, one set a frame where it renders more than one (keys
    f<frame>/<Pass>.<channel>), whole (the scripts' 64-pixel guard band
    included), finite float32; each substituted hold bounds outputs of
    the reference by a positive MSE far below the reference's own bound
    (where it has one)."""
    settings, bound = settings_of(name), chip_smoke.MID_REFS[name]
    sub_bound = chip_smoke.MID_SUBSTITUTED_BOUND[name]
    path = chip_smoke.mid_ref_file(name).with_suffix(".rasters.npz")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    frames = [""] if settings["frames"] == 1 else [
        f"f{i}/" for i in range(settings["frames"])]
    assert sorted(arrays) == sorted(f + c for f in frames
                                    for c in settings["substituted"])
    h, w = settings["height"] + 128, settings["width"] + 128
    for key, a in arrays.items():
        # the raster SD map has the SD grid's texels and k samples each
        whole = ((h, w) if "StochasticDepthMap." not in key else
                 (-(-h // 4), -(-w // 4)))
        assert a.dtype == np.float32 and a.shape[:2] == whole, key
        assert np.isfinite(a).all(), key
    for f in frames:
        depth = arrays[f + "GBufferRaster.depth"]
        assert 0.0 < depth.min() and depth.max() <= 1.0
    assert set(sub_bound) <= set(settings["outputs"])
    for out, b in sub_bound.items():
        assert 0.0 < b, out
        if bound[out] is not None:
            assert b < bound[out] / 1e3, out


def test_anim_ref_records_config5_animation():
    """SVAO_anim is BASELINE config 5's animation (chip_smoke.
    CONFIG5_ANIMATION, bench_configs.py:51-66) on the small EmeraldSquare
    tier, frames 0-2 with frame 2 kept, and otherwise SVAO_small.py's
    settings; its stored G-buffer differs between frames (the camera and
    the node move), and its depth2-free graph ran only the G-buffer and
    ForwardLighting rasters."""
    anim = settings_of("SVAO_anim")
    base = settings_of("SVAO_small")
    assert anim["animation"] == chip_smoke.CONFIG5_ANIMATION
    assert (anim["scene"], anim["frames"], anim["frame"]) == (
        "EmeraldSquare", 3, 2)
    differ = ("scene", "frames", "frame", "outputs", "animation")
    assert {k: v for k, v in anim.items() if k not in differ} == {
        k: v for k, v in base.items() if k not in differ}
    assert set(anim["outputs"]) < set(base["outputs"])
    with np.load(chip_smoke.mid_ref_file("SVAO_anim")) as f:
        settings = json.loads(str(f["settings"]))
    assert settings["raster_overflow"] == {"ForwardLighting": 0,
                                           "GBufferRaster": 0}
    path = chip_smoke.mid_ref_file("SVAO_anim").with_suffix(".rasters.npz")
    with np.load(path) as f:
        mvec = [f[f"f{i}/GBufferRaster.mvec"] for i in range(3)]
        depth = [f[f"f{i}/GBufferRaster.depth"] for i in range(3)]
    assert not np.array_equal(depth[1], depth[2])
    assert np.abs(mvec[2]).max() > 100 * np.abs(mvec[0]).max()
