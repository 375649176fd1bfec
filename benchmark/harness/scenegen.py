"""A cell's inputs: the scene, made from its configuration's generator
parameters and the run's seed by the frozen copy of the port's town
generator (reference/port/scene/procedural.py:_town), as numpy arrays
that the program and the reference each upload themselves.

The town is the configuration's (its base seed and counts), the scene
load_scene builds; the run's seed moves the whole of it by a rigid offset
in the ground plane of up to `seed_offset` units on each axis (seed 0: no
offset). So every seed renders the same work, sampled at other points: a
layout drawn anew from the seed changed config 4's frame time by up to
15% (PERF.md), more than two runs of one seed differ."""
from __future__ import annotations

import numpy as np

GENERATOR_KEYS = ("n_buildings", "n_props", "extent", "columns", "trees",
                  "leaves_per_tree", "cam_height")


def make_inputs(scene_cfg: dict, seed: int, aspect: float,
                node_tallest_share: int | None = None):
    """(arrays, camera): the scene's fields (SCENE_FIELDS, numpy; None for
    an absent optional field) and its camera's (CAMERA_FIELDS). With
    node_tallest_share = n, the tallest 1/n of the triangles by centroid
    height become node 1 (the animated node), the rest node 0."""
    from reference.port.scene.camera import CAMERA_FIELDS
    from reference.port.scene.procedural import _town
    from reference.port.scene.scene import SCENE_FIELDS
    if seed < 0:
        raise ValueError("--seed must be a non-negative whole number")
    scene = _town(scene_cfg["name"], seed=int(scene_cfg["seed"]),
                  aspect=aspect, device="cpu",
                  **{k: scene_cfg[k] for k in GENERATOR_KEYS})
    arrays = {f: None if getattr(scene, f) is None
              else getattr(scene, f).numpy() for f in SCENE_FIELDS}
    if seed:
        s = float(scene_cfg["seed_offset"])
        dx, dz = np.random.default_rng(seed).uniform(-s, s, 2)
        arrays["positions"] = arrays["positions"] + np.asarray(
            [dx, 0.0, dz], np.float32)
    camera = {f: getattr(scene.camera, f).numpy() for f in CAMERA_FIELDS}
    if node_tallest_share:
        cent = arrays["positions"].mean(1)
        sel = np.argsort(cent[:, 1])[-len(cent) // node_tallest_share:]
        node = np.zeros(len(cent), np.int32)
        node[sel] = 1
        arrays["node_id"] = node
    return arrays, camera
