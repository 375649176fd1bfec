"""Drives a renderer package the way a user's script does: the
configuration's graph script through the package's run_script, the
cell's scene handed over as arrays (scene_from_numpy), its camera path and
node track, then Renderer.renderFrame once a frame with the clock set to
the frame's index. The same code drives the program (rtsdm_tpu_torch) and
the reference (reference.port, the frozen plain copy), each from its own
package."""
from __future__ import annotations

import importlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent   # the checkout


class Driver:
    def __init__(self, package: str):
        self.package = package
        self.mogwai = importlib.import_module(f"{package}.mogwai")
        self.scene_mod = importlib.import_module(f"{package}.scene.scene")
        self.animation = importlib.import_module(f"{package}.scene.animation")

    def build(self, cfg: dict, wl: dict, arrays: dict, camera: dict,
              script: str, device: str = "cuda"):
        """A Renderer with the graph of `script` (relative to the
        checkout) on the cell's scene, animated as the cell says."""
        m = self.mogwai.Renderer(width=int(cfg["width"]),
                                 height=int(cfg["height"]), device=device)
        self.mogwai.run_script(str(ROOT / script), m)
        for name, props in cfg.get("pass_overrides", {}).items():
            m.active_graph.get_pass(name).cfg.update(props)
        scene = self.scene_mod.scene_from_numpy(arrays, camera, device=device,
                                                name=cfg["scene"]["name"])
        m.scene = scene
        for g in m.graphs:
            g.set_scene(scene)
        anim = wl.get("animation") or {}
        a = self.animation
        if "camera_orbit" in anim:
            m.cameraPath = a.CameraPath.orbit(**anim["camera_orbit"])
        if "camera_path" in anim:
            path = anim["camera_path"]
            m.cameraPath = a.CameraPath(path["positions"], path["targets"],
                                        duration=float(path["duration"]))
        if "node_track" in anim:
            track = anim["node_track"]
            m.animationController = a.AnimationController(
                {int(anim["node"]): a.NodeTrack.oscillate(
                    tuple(track["axis"]), amplitude=float(track["amplitude"]),
                    period=float(track["period"]))})
        m.clock.play()
        return m

    @staticmethod
    def render(m, frame: int):
        """Frame `frame` of the cell's path: its outputs, cropped."""
        m.clock.frame = frame
        return m.renderFrame()
