"""The mid-size references of tests/torch_refs/ (the JAX package's render
of scripts/SVAO_small.py above every golden's size, made by
tests/torch_refs/make_refs.py): they load, hold finite images of the size
they record, and record the settings chip_smoke.py renders the port with
when it holds the card against them. Nothing is rendered here.

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


@pytest.fixture(scope="module")
def ref():
    with np.load(chip_smoke.MID_REF_FILE) as f:
        return {k: f[k] for k in f.files}


def test_mid_size_refs_record_what_chip_smoke_renders(ref):
    settings = json.loads(str(ref["settings"]))
    assert {k: settings[k] for k in chip_smoke.MID_REF} == chip_smoke.MID_REF
    assert set(chip_smoke.MID_MSE_BOUND) == set(settings["outputs"])
    assert settings["width"] * settings["height"] > 128 * 128  # > goldens
    # the JAX package's raster dropped no triangle in any tile
    assert settings["overflow"] == 0
    for name in settings["outputs"]:
        img = ref[name]
        assert img.dtype == np.float32
        assert img.shape[:2] == (settings["height"], settings["width"])
        assert img.shape[2] in (3, 4)
        assert np.isfinite(img).all()
    ao = ref["AmbientOcclusion.out"][..., 0]
    assert 0.0 <= ao.min() < 0.9 and ao.max() <= 1.0
