"""Mogwai: the script-driven renderer harness (counterpart of
rtsdm_tpu/mogwai.py; reference Source/Mogwai, MogwaiScripting.cpp:127-179).

    python -m rtsdm_tpu_torch.mogwai scripts/SVAO_small.py \
        --scene SunTemple@full --width 1920 --height 1080 --frames 3

A graph script sees the renderer as `m` (m.addGraph, m.loadScene, ...).
renderFrame runs the active graph eagerly, pass by pass, and ends with
torch.cuda.synchronize(); `m.profiler` (off by default) times the frame,
its animation step and camera path, each pass and the spans inside them on
the host clock (core/profiler.py). A GuardBand pass in the graph grows the
render target by 2 * guardBand on each axis and widens the camera's field
of view so the interior keeps the requested one (GuardBand.cpp:74-100);
marked outputs are cropped back to the requested size. `m.cameraPath` (a
scene/animation.py CameraPath) moves the camera and `m.animationController`
(an AnimationController) the geometry, by the clock's time. Runs on the
GPU unless the renderer is given device="cpu".
"""
from __future__ import annotations

import glob
import math
import os
import runpy
import sys
import time

import torch

from . import falcor
from .core.clock import Clock
from .core.frame_capture import FrameCapture
from .core.profiler import Profiler
from .core.settings import Settings
from .rendergraph.graph import RenderGraph
from .rendergraph.render_pass import RenderContext
from .scene.camera import Camera
from .scene.procedural import load_scene
from .utils.device import resolve_device


class Renderer:
    """The `m` object."""

    def __init__(self, width: int = 1920, height: int = 1080,
                 device="cuda"):
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.clock = Clock()
        self.settings = Settings()
        self.profiler = Profiler(enabled=False)
        self.frameCapture = FrameCapture()
        self.frameCapture._attach(self)
        self.graphs: list[RenderGraph] = []
        self.active_graph: RenderGraph | None = None
        self.scene = None
        self.cameraPath = None           # scene/animation.py CameraPath
        self.animationController = None  # scene/animation.py controller
        self.last_frame_ms = None      # host clock of the last renderFrame
        self._scene_name = None
        self._state = None
        self._frame_fn = None
        self._scene_comp = None        # guard-band-compensated bind pose
        self._last_outputs = None

    # --- script API -----------------------------------------------------
    def addGraph(self, graph: RenderGraph):
        self.graphs.append(graph)
        self.active_graph = graph
        self._apply_settings(graph)
        if self.scene is not None:
            graph.set_scene(self.scene)
        self._invalidate()

    def removeGraph(self, graph: RenderGraph):
        self.graphs.remove(graph)
        if self.active_graph is graph:
            self.active_graph = self.graphs[-1] if self.graphs else None
        self._invalidate()

    def addOptions(self, source):
        """Options from a dict or a JSON/TOML file; 'RenderPass:<Type>'
        entries override matching pass properties, and attribute filters
        match '<graph>:<pass>' subjects (Settings.h:297-324)."""
        self.settings.add_options(source)
        for g in self.graphs:
            self._apply_settings(g)
        self._invalidate()

    def clearOptions(self):
        self.settings._options.clear()

    def loadScene(self, path: str):
        """A procedural scene by name ('CornellBox', 'SunTemple@full', ...;
        scene/procedural.py). Scene files are not ported yet."""
        if os.path.splitext(path)[1]:
            raise NotImplementedError(
                f"loadScene({path!r}): scene files are not ported yet; "
                "use a procedural scene name")
        if int(self.settings.get_option("Scene:emissiveVirtualLights", 0)):
            raise NotImplementedError("Scene:emissiveVirtualLights is not "
                                      "ported yet")
        self._scene_name = path
        self.scene = load_scene(path, aspect=self.width / self.height,
                                device=self.device)
        for g in self.graphs:
            g.set_scene(self.scene)
        self._invalidate()

    def resizeFrameBuffer(self, width: int, height: int):
        self.width, self.height = width, height
        if self._scene_name:
            self.loadScene(self._scene_name)
        self._invalidate()

    def _invalidate(self):
        self._frame_fn = None
        self._state = None

    def _apply_settings(self, graph: RenderGraph):
        for name, p in graph.passes.items():
            opts = self.settings.get_option(f"RenderPass:{p.pass_type}")
            if isinstance(opts, dict):
                for key, val in opts.items():
                    if key in p.cfg:
                        p.cfg[key] = val
            subject = f"{graph.name}:{name}"
            for key in list(p.cfg):
                val = self.settings.get_attribute(subject, key, None)
                if val is not None:
                    p.cfg[key] = val

    # --- frame loop -------------------------------------------------------
    def _guard_band(self) -> int:
        for p in self.active_graph.passes.values():
            if p.pass_type == "GuardBand":
                return int(p.cfg["guardBand"])
        return 0

    def _render_res(self):
        gb = self._guard_band()
        return self.width + 2 * gb, self.height + 2 * gb, gb

    def _compensated_scene(self):
        """Widen the field of view so the guard-band interior keeps the
        requested one (the reference's 'Fix Camera Fov',
        GuardBand.cpp:96-100)."""
        gb = self._guard_band()
        if gb == 0:
            return self.scene
        cam = self.scene.camera
        h = self.height / 2 + gb
        fov = 2.0 * math.atan(0.5 * float(cam.frame_height)
                              / float(cam.focal_length))
        new_fov = 2.0 * math.atan(h * math.tan(fov * 0.5) / (h - gb))
        new_focal = 0.5 * float(cam.frame_height) / math.tan(new_fov * 0.5)
        rw, rh, _ = self._render_res()
        new_cam = Camera.create(
            position=cam.pos_w.cpu().numpy(), target=cam.target.cpu().numpy(),
            up=cam.up.cpu().numpy(), focal_length=new_focal,
            frame_height=float(cam.frame_height), aspect=rw / rh,
            near_z=float(cam.near_z), far_z=float(cam.far_z),
            device=self.device)
        return self.scene.with_camera(new_cam)

    def _build_frame_fn(self):
        graph = self.active_graph
        rw, rh, gb = self._render_res()
        scene = self._compensated_scene()
        graph.set_scene(scene)
        ctx = RenderContext(width=rw, height=rh, scene=scene,
                            dictionary={"guardBand": gb})
        self._state = graph.init_state(ctx)
        self._frame_fn = graph.frame_fn(rw, rh, dictionary={"guardBand": gb},
                                        profiler=self.profiler)
        self._scene_comp = scene

    def renderFrame(self):
        """Render one frame of the active graph; returns the marked outputs
        cropped to the requested size."""
        if self.active_graph is None or self.scene is None:
            raise RuntimeError("need addGraph + loadScene before renderFrame")
        if self._frame_fn is None:
            self._build_frame_fn()
        t0 = time.perf_counter()
        prof, frame = self.profiler, self.clock.frame
        with prof.activate():
            # _scene_comp stays the bind pose: node tracks are absolute, so
            # each frame animates it afresh (never last frame's soup, which
            # would compound the transforms)
            scene = self._scene_comp
            if self.animationController is not None:
                with prof.event("animate", frame=frame):
                    scene = self.animationController.animate(
                        scene, self.clock.time)
            if self.cameraPath is not None:
                with prof.event("camera_path", frame=frame):
                    base = self._scene_comp.camera
                    scene = scene.with_camera(self.cameraPath.camera_at(
                        self.clock.time, base, dt=1.0 / self.clock.framerate,
                        aspect=float(base.aspect),
                        focal=float(base.focal_length)))
            with prof.event("renderFrame", frame=frame):
                marked, self._state = self._frame_fn(
                    scene, self._state, frame_index=frame,
                    time=self.clock.time)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.last_frame_ms = (time.perf_counter() - t0) * 1e3
        _, _, gb = self._render_res()
        if gb:
            marked = {k: v[gb:gb + self.height, gb:gb + self.width]
                      if v.dim() >= 2 else v for k, v in marked.items()}
        self._last_outputs = marked
        self.clock.tick()
        return marked


def load_plugins(paths) -> list[str]:
    """Pass plugins (reference PluginRegistry, Core/Plugin.h): each path is
    a .py file, or a directory whose .py files are run once in name order;
    a plugin registers its passes with rendergraph.render_pass.register_pass.
    Returns the pass types that were new."""
    from .rendergraph.render_pass import PASS_REGISTRY
    before = set(PASS_REGISTRY)
    files = []
    for p in paths:
        files += (sorted(glob.glob(os.path.join(p, "*.py")))
                  if os.path.isdir(p) else [p])
    for f in files:
        runpy.run_path(f, run_name=f"rtsdm_plugin_{os.path.basename(f)}")
    return sorted(set(PASS_REGISTRY) - before)


def run_script(path: str, m: Renderer | None = None,
               scene: str | None = None):
    """Execute a graph script as Mogwai does (Mogwai.h:111): the script
    sees `m`, and `from falcor import *` gives this package's names."""
    m = m or Renderer()
    with falcor.installed():
        ns = runpy.run_path(path, init_globals={"m": m})
    if scene:
        m.loadScene(scene)
    return m, ns


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Mogwai-style script runner")
    ap.add_argument("script")
    ap.add_argument("--scene", default="CornellBox")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--capture", default=None,
                    help="directory for each frame's marked outputs: "
                         "Mogwai.<graph>.<output>.<frame>.npy and .png")
    ap.add_argument("--profile", action="store_true",
                    help="print each pass's time (CUDA events) per frame and "
                         "the profiler's capture at the end")
    ap.add_argument("--plugin", action="append", default=[],
                    help="pass-plugin .py file or directory (repeatable)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.plugin:
        load_plugins(args.plugin)
    m = Renderer(width=args.width, height=args.height, device=args.device)
    run_script(args.script, m)
    m.loadScene(args.scene)
    m.clock.pause()
    m.active_graph.time_passes = args.profile and m.device.type == "cuda"
    m.profiler.enabled = args.profile
    for f in range(args.frames):
        m.clock.frame = f
        m.renderFrame()
        line = f"frame {f}: {m.last_frame_ms:.3f} ms (host clock)"
        if m.active_graph.time_passes:
            line += "; passes (ms): " + ", ".join(
                f"{n} {t:.3f}" for n, t in
                m.active_graph.pass_times_ms().items())
        print(line, flush=True)
        if args.capture:
            m.frameCapture.outputDir = args.capture
            m.frameCapture.capture()
    print("outputs:", {k: tuple(v.shape) for k, v in m._last_outputs.items()})
    if args.profile:
        print(m.profiler.capture_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
