"""The mid-size references of tests/torch_refs/ (the JAX package's renders
of scripts/SVAO_small.py, scripts/HBAO.py, BASELINE config 2,
scripts/SVAO.py, scripts/SVAO.py under DualDepth and scripts/
SVAO_quarter.py above every golden's size, made by
tests/torch_refs/make_refs.py): they load,
hold finite float32 images of the size they record, and record the
settings chip_smoke.py renders the port with when it holds the card
against them, the JAX package's accelerator branches included (hazards f,
k, l and m of ROADMAP.md). Nothing is rendered here.

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
      "SVAO_quarter": "AmbientOcclusion.out", "SVAO_dual": "AmbientRef.out"}


@pytest.fixture(scope="module", params=sorted(chip_smoke.MID_REFS))
def ref(request):
    with np.load(chip_smoke.mid_ref_file(request.param)) as f:
        return request.param, {k: f[k] for k in f.files}


def test_mid_size_refs_record_what_chip_smoke_renders(ref):
    name, ref = ref
    settings = json.loads(str(ref["settings"]))
    want, bound = chip_smoke.MID_REFS[name]
    assert {k: settings.get(k) for k in want} == want
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
    """HBAO's reference shifts (hazard l) and config 2's rasters its SD map
    through the Pallas kernel (hazard m), as the port does on the card;
    every reference takes the accelerator's shadows (hazard k) and raster
    caps (hazard f); config 2 differs from SVAO_small.py only there."""
    refs = chip_smoke.MID_REFS
    hbao, sd = refs["HBAO"][0], refs["SVAO_rasterSD"][0]
    assert hbao["script"] == "scripts/HBAO.py"
    assert hbao["pass_overrides"]["HBAO"] == {"samplingMode": "Shift"}
    assert sd["pass_overrides"]["SVAO"] == {"stochasticDepthImpl": "Raster"}
    assert sd["pass_overrides"]["SVAO"] == \
        chip_smoke.CONFIGS["config2"][4]["SVAO"]
    assert "raster_stochastic_pallas" in sd["raster_sd"]
    base = refs["SVAO_small"][0]
    assert {k: v for k, v in sd.items() if k != "raster_sd"} == dict(
        base, pass_overrides={**base["pass_overrides"],
                              "SVAO": sd["pass_overrides"]["SVAO"]})
    for settings, _ in refs.values():
        assert "any_hit_pallas" in settings["shadows"]
        # scripts/SVAO_quarter.py has no DepthPeeling pass
        rasters = ("GBufferRaster", "ForwardLighting") + (
            () if "quarter" in settings["script"] else ("DepthPeeling",))
        for p in rasters:
            assert settings["pass_overrides"][p] == {"maxPerTile": 4096}


def test_svao_full_ref_records_four_raster_caps_and_its_outputs():
    """scripts/SVAO.py's reference differs from SVAO_small.py's only in the
    script, its kept outputs (DiffuseDLSS.output, a pass-through stub, left
    out and said so), and its fourth raster pass, DepthPass, capped as the
    others (hazard f); the file records that the graph ran only the
    G-buffer and ForwardLighting rasters, neither overflowing, and the
    accelerator branches chip_smoke.py takes."""
    full, bound = chip_smoke.MID_REFS["SVAO_full"]
    base = chip_smoke.MID_REFS["SVAO_small"][0]
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
    refs = chip_smoke.MID_REFS
    quarter, dual, full = (refs[n][0] for n in ("SVAO_quarter", "SVAO_dual",
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
