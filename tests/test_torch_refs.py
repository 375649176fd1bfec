"""The mid-size references of tests/torch_refs/ (the JAX package's renders
of scripts/SVAO_small.py, scripts/HBAO.py and BASELINE config 2 above
every golden's size, made by tests/torch_refs/make_refs.py): they load,
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
      "SVAO_rasterSD": "AmbientOcclusion.out"}


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
    # the JAX package's raster dropped no triangle in any tile
    assert settings["overflow"] == 0
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
        for p in ("GBufferRaster", "DepthPeeling", "ForwardLighting"):
            assert settings["pass_overrides"][p] == {"maxPerTile": 4096}
