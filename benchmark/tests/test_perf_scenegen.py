"""The frozen generator: seed 0 is the scene the port's load_scene builds,
and every seed gives the configuration's triangle count."""
import numpy as np
import perfutil
import pytest

from harness import scenegen


@pytest.mark.parametrize("config", ["bistro_1080p", "emerald_720p"])
def test_seed_zero_is_load_scene(config):
    from rtsdm_tpu_torch.scene.procedural import load_scene
    from rtsdm_tpu_torch.scene.scene import SCENE_FIELDS
    cfg = perfutil.load("configs", config)
    aspect = cfg["width"] / cfg["height"]
    arrays, camera = scenegen.make_inputs(cfg["scene"], 0, aspect)
    s = load_scene(cfg["scene"]["name"] + "@full", aspect=aspect,
                   device="cpu")
    for f in SCENE_FIELDS:
        a, b = arrays[f], getattr(s, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b.numpy()), f
    assert np.array_equal(camera["view_proj_mat"],
                          s.camera.view_proj_mat.numpy())
    assert arrays["positions"].shape[0] == cfg["triangles"]


@pytest.mark.parametrize("seed", [1, 2**31 + 12345])
def test_a_seed_moves_the_same_town(seed):
    cfg = perfutil.load("configs", "bistro_1080p")
    small = dict(cfg["scene"], trees=30, leaves_per_tree=20)
    base, cam0 = scenegen.make_inputs(small, 0, 1.5)
    other, cam = scenegen.make_inputs(small, seed, 1.5)
    assert other["positions"].shape == base["positions"].shape
    shift = (other["positions"] - base["positions"]).reshape(-1, 3)
    assert np.abs(shift[:, 1]).max() == 0.0
    assert 0.0 < np.abs(shift[:, [0, 2]]).max() <= small["seed_offset"] + 1e-5
    assert np.ptp(shift[:, [0, 2]], 0).max() < 1e-4     # one rigid offset
    for f in base:
        if f != "positions" and base[f] is not None:
            assert np.array_equal(other[f], base[f]), f
    assert np.array_equal(cam["view_proj_mat"], cam0["view_proj_mat"])


def test_tallest_share_marks_the_node():
    cfg = perfutil.load("configs", "emerald_720p")
    small = dict(cfg["scene"], trees=20, leaves_per_tree=10)
    arrays, _ = scenegen.make_inputs(small, 3, 16 / 9, 50)
    node = arrays["node_id"]
    k = -(-len(node) // 50)      # bench_configs.py:58's selection
    assert node.sum() == k
    h = arrays["positions"].mean(1)[:, 1]
    assert np.array_equal(np.sort(h[node == 1]), np.sort(h)[-k:])
