#!/usr/bin/env python3
"""Generate the mid-size references that chip_smoke.py holds the port
against: a graph script rendered by the JAX package (rtsdm_tpu) on the
CPU, as the golden runner renders (use_jit=False, the script's own
properties, a paused clock), at a size above every golden's. Four
configurations (REFS): scripts/SVAO_small.py; scripts/HBAO.py (BASELINE
config 1); scripts/SVAO_small.py with SVAO's stochasticDepthImpl set to
"Raster" after the graph was built (BASELINE config 2, as
bench_configs.py:20-23 sets it); scripts/SVAO.py, the shipped research
graph (SVAO_full), and with SVAO's primaryDepthMode set to DualDepth after
the graph was built (SVAO_dual); scripts/SVAO_quarter.py (BASELINE config
4's graph: quarter-res SVAO with dualAO, DownsamplePass, AOGuidedBlur).

Wherever a CPU tier of the JAX package departs from its accelerator path,
which the port follows, the reference takes the accelerator's behaviour:

* the JAX package's CPU raster (its XLA tier) keeps at most maxPerTile
  triangles in each screen tile and drops the rest; at this size the
  scripts' 256 drops some, where the port's raster (like the reference's
  GPU raster) drops none. So the raster passes (GBufferRaster,
  DepthPeeling, ForwardLighting and, in SVAO.py, DepthPass) get a
  maxPerTile at which the XLA raster drops nothing (the pass overrides
  below, as the golden tests set theirs); the script records the overflow
  of every raster pass the graph runs (SVAO.py runs only GBufferRaster and
  ForwardLighting), fails unless each is 0, and records the
  G-buffer raster's overflow at 256 beside them;
* RayShadow takes the JAX package's accelerator branch (accelerator_branch):
  on the CPU the package calls its XLA any-hit (ops/rt.py:any_hit), which
  ignores alpha masks, so masked triangles (Arcade's foliage and grilles)
  cast shadows there and nowhere else; the accelerator branch,
  any_hit_pallas, tests the masks, as the reference does and as the port
  does;
* HBAO samples with samplingMode "Shift" (a pass override): under "Auto"
  the JAX package gathers on the CPU and shifts on an accelerator, and the
  port shifts on the card (K6);
* the raster stochastic-depth pass (config 2) takes the JAX package's
  accelerator branch, raster_stochastic_pallas: its XLA tier caps each
  tile's list at maxPerTile and hashes fragments differently from the
  Pallas kernel, which the port's K9 follows.

The Pallas kernels run here in interpret mode, as the package's own
interpret tests run them.

    JAX_PLATFORMS=cpu python tests/torch_refs/make_refs.py [--config NAME]

    JAX_PLATFORMS=cpu python tests/torch_refs/make_refs.py --golden TEST

renders the golden test tests/image_tests/renderpasses/TEST.py as the
golden runner does (rtsdm_tpu/testing/image_tests.py: run_test), but with
XLA's fused multiply-adds off (XLA_FLAGS=--xla_cpu_max_isa=AVX; compiled,
the package's CPU raster contracts a*b+c in its edge functions, which the
port's raster and K1 do not), into tests/torch_refs/TEST.nofma.npz: the
kept frames' outputs and, in `settings`, each one's MSE against the
committed golden.

The first form writes tests/torch_refs/<NAME>.<scene>.<W>x<H>.f<frame>.npz
with the graph's marked outputs of the recorded frame (float32, compressed) and a
JSON `settings` entry: script, scene, width, height, frames rendered, the
frame kept, the outputs, the pass overrides, the accelerator branches
taken, every raster pass's overflow, the G-buffer raster's overflow at 256
and at the override, the outputs left out and why, and the render's
seconds. The tier-1 tests only load these files
(tests/test_torch_refs.py); they never run this script.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = Path(__file__).resolve().parent

# what chip_smoke.py renders through the port (read back by the tier-1 test
# that checks the two agree)
MAX_PER_TILE = 4096
RASTER_PASSES = ("GBufferRaster", "DepthPeeling", "ForwardLighting",
                 "DepthPass")
RASTER_CAPS = {p: {"maxPerTile": MAX_PER_TILE} for p in RASTER_PASSES[:3]}
SHADOWS = "RayShadow through any_hit_pallas (interpret mode)"
SETTINGS = dict(script="scripts/SVAO_small.py", scene="Arcade@full",
                width=480, height=270, frames=1, frame=0,
                outputs=["AmbientOcclusion.out", "Shaded.out",
                         "AmbientOcclusionTAA.colorOut",
                         "ShadedTAA.colorOut"],
                pass_overrides=RASTER_CAPS, shadows=SHADOWS)
HBAO_SETTINGS = dict(script="scripts/HBAO.py", scene="Arcade@full",
                     width=480, height=270, frames=1, frame=0,
                     outputs=["Ambient.out", "Diffuse.out"],
                     pass_overrides={**RASTER_CAPS,
                                     "HBAO": {"samplingMode": "Shift"}},
                     shadows=SHADOWS)
RASTER_SD_SETTINGS = dict(
    SETTINGS, pass_overrides={**RASTER_CAPS,
                              "SVAO": {"stochasticDepthImpl": "Raster"}},
    raster_sd="StochasticDepthMap through raster_stochastic_pallas "
              "(interpret mode)")
SVAO_FULL_SETTINGS = dict(
    SETTINGS, script="scripts/SVAO.py",
    outputs=["AmbientRef.out", "DiffuseRef.out", "AmbientTAA.colorOut",
             "DiffuseTAA.colorOut"],
    pass_overrides={p: {"maxPerTile": MAX_PER_TILE} for p in RASTER_PASSES},
    left_out={"DiffuseDLSS.output": "DLSSPass is a pass-through stub "
                                    "(passes/stubs.py): DiffuseRef.out"})
# BASELINE config 4's graph (quarter-res SVAO with dualAO, DownsamplePass
# and AOGuidedBlur), which has no DepthPeeling pass
QUARTER_SETTINGS = dict(
    SETTINGS, script="scripts/SVAO_quarter.py",
    outputs=["AmbientOcclusion.out", "ShadedTAA.colorOut"],
    pass_overrides={p: {"maxPerTile": MAX_PER_TILE}
                    for p in ("GBufferRaster", "ForwardLighting")})
# scripts/SVAO.py with SVAO's primaryDepthMode set to DualDepth after the
# graph was built: DepthPeeling and LinearizeDepth0 feed its depth2
DUAL_SETTINGS = dict(
    SVAO_FULL_SETTINGS, outputs=["AmbientRef.out"],
    pass_overrides={**SVAO_FULL_SETTINGS["pass_overrides"],
                    "SVAO": {"primaryDepthMode": "DualDepth"}},
    left_out={"DiffuseRef.out": "kept small: SVAO_full holds it",
              "AmbientTAA.colorOut": "kept small: SVAO_full holds it",
              "DiffuseTAA.colorOut": "kept small: SVAO_full holds it",
              **SVAO_FULL_SETTINGS["left_out"]})
# file name prefix -> settings
REFS = {"SVAO_small": SETTINGS, "HBAO": HBAO_SETTINGS,
        "SVAO_rasterSD": RASTER_SD_SETTINGS, "SVAO_full": SVAO_FULL_SETTINGS,
        "SVAO_quarter": QUARTER_SETTINGS, "SVAO_dual": DUAL_SETTINGS}


# Pallas kernels run in interpret mode, per pass whose branch was patched
INTERPRETED = collections.Counter()


@contextlib.contextmanager
def accelerator_branch(pass_cls, kernels):
    """While it holds, pass_cls.execute runs the JAX package's accelerator
    branch on the CPU: jax.devices() reports an accelerator inside it and
    the Pallas kernels of module `kernels` run in interpret mode."""
    from unittest import mock
    import jax
    accelerator = [type("Device", (), {"platform": "tpu"})()]
    real_call, real_exec = kernels.pl.pallas_call, pass_cls.execute

    def interpreted(*a, **kw):
        INTERPRETED[pass_cls.__name__] += 1
        return real_call(*a, **dict(kw, interpret=True))

    def execute(self, ctx, inputs, state=None):
        with mock.patch.object(jax, "devices", lambda *a, **k: accelerator), \
                mock.patch.object(kernels.pl, "pallas_call", interpreted):
            return real_exec(self, ctx, inputs, state)

    pass_cls.execute = execute
    try:
        yield
    finally:
        pass_cls.execute = real_exec


def reference_shadows():
    """RayShadow through any_hit_pallas (accelerator_branch)."""
    from rtsdm_tpu.ops import rt_pallas
    from rtsdm_tpu.passes.lighting import RayShadow
    return accelerator_branch(RayShadow, rt_pallas)


@contextlib.contextmanager
def reference_branches(settings: dict):
    """The accelerator branches `settings` records: the shadows always, the
    raster stochastic depth through raster_stochastic_pallas where the
    settings name it."""
    from rtsdm_tpu.ops import raster_pallas
    from rtsdm_tpu.passes.stochastic_depth import StochasticDepthMap
    with contextlib.ExitStack() as st:
        st.enter_context(reference_shadows())
        if "raster_sd" in settings:
            st.enter_context(accelerator_branch(StochasticDepthMap,
                                                raster_pallas))
        yield


@contextlib.contextmanager
def raster_overflow():
    """While it holds, every call of the JAX package's rasterize made by a
    pass of RASTER_PASSES adds its overflow (triangle-tile entries the XLA
    raster dropped) to the yielded {pass: entries}; a call from any other
    pass fails the render. A raster pass that the graph's liveness prunes
    (SVAO.py's DepthPass, whose one edge orders it, and DepthPeeling,
    whose depth2 SVAO reads only under DualDepth) adds no key."""
    from unittest import mock
    from rtsdm_tpu.passes import depth_chain, gbuffer, lighting
    classes = (gbuffer.GBufferRaster, depth_chain.DepthPeeling,
               lighting.ForwardLighting, gbuffer.DepthPass)
    seen = collections.Counter()
    running = []
    real_raster = gbuffer.rasterize

    def rasterize(*a, **kw):
        if len(running) != 1:
            raise SystemExit(f"rasterize called outside {RASTER_PASSES}")
        vis = real_raster(*a, **kw)
        seen[running[0]] += int(vis["overflow"])
        return vis

    def tracked(cls):
        real = cls.execute

        def execute(self, ctx, inputs, state=None):
            running.append(cls.__name__)
            try:
                return real(self, ctx, inputs, state)
            finally:
                running.pop()
        return mock.patch.object(cls, "execute", execute)

    with contextlib.ExitStack() as st:
        for mod in (gbuffer, depth_chain):
            st.enter_context(mock.patch.object(mod, "rasterize", rasterize))
        for cls in classes:
            st.enter_context(tracked(cls))
        yield seen


def ref_path(name: str, settings: dict) -> Path:
    scene = settings["scene"].replace("@", "_")
    return OUT_DIR / (f"{name}.{scene}.{settings['width']}x"
                      f"{settings['height']}.f{settings['frame']}.npz")


def render(settings: dict):
    """({output: float32 image} of the kept frame, rendered by rtsdm_tpu;
    the renderer)."""
    import numpy as np
    from rtsdm_tpu.mogwai import Renderer, run_script
    m = Renderer(width=settings["width"], height=settings["height"],
                 use_jit=False)
    run_script(str(ROOT / settings["script"]), m)
    for name, props in settings["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    m.loadScene(settings["scene"])
    m.clock.pause()
    kept = {}
    for f in range(settings["frames"]):
        m.clock.frame = f
        out = m.renderFrame()
        if f == settings["frame"]:
            kept = {k: np.asarray(v, np.float32) for k, v in out.items()
                    if k in settings["outputs"]}
    missing = set(settings["outputs"]) - set(kept)
    if missing:
        raise SystemExit(f"outputs not marked by the graph: {missing}")
    return kept, m


def gbuffer_overflow(m, settings: dict, max_per_tile: int) -> int:
    """Triangle-tile entries the XLA raster drops in the kept frame's
    G-buffer raster (the GBufferRaster pass's jittered camera, at the
    guard-banded target size) with `max_per_tile`."""
    from rtsdm_tpu.ops.raster import rasterize
    from rtsdm_tpu.passes.gbuffer import pattern_jittered_scene
    graph = m.active_graph
    gb = graph.get_pass("GBufferRaster").cfg
    guard = int(graph.get_pass("GuardBand").cfg["guardBand"])
    w, h = settings["width"] + 2 * guard, settings["height"] + 2 * guard
    scene = pattern_jittered_scene(m.scene, gb["samplePattern"],
                                   gb["sampleCount"], settings["frame"], w,
                                   h)
    cam = scene.camera
    vis = rasterize(cam.view_proj_no_jitter, scene.positions, width=w,
                    height=h, jitter_x=cam.jitter_x, jitter_y=cam.jitter_y,
                    cull=gb["cull"].lower(), max_per_tile=max_per_tile)
    return int(vis["overflow"])


NO_FMA = "--xla_cpu_max_isa=AVX"


def golden_without_fma(test: str) -> int:
    """The golden test's frames rendered by rtsdm_tpu with XLA's fused
    multiply-adds off, written with their MSE against the goldens."""
    import numpy as np
    from rtsdm_tpu.mogwai import Renderer, run_script
    path = ROOT / "tests" / "image_tests" / "renderpasses" / f"{test}.py"
    ns = {}
    exec(path.read_text(), ns)
    cfg = ns["IMAGE_TEST"]
    t0 = time.perf_counter()
    m = Renderer(width=cfg["width"], height=cfg["height"], use_jit=False)
    run_script(str(ROOT / ns["SCRIPT"]), m)
    m.active_graph.get_pass("GuardBand").cfg["guardBand"] = cfg["guard_band"]
    for name, props in cfg.get("pass_overrides", {}).items():
        m.active_graph.get_pass(name).cfg.update(props)
    m.loadScene(cfg["scene"])
    m.clock.pause()
    images = {}
    for f in range(max(cfg["frames"]) + 1):
        m.clock.frame = f
        out = m.renderFrame()
        if f in cfg["frames"]:
            images.update({f"{k}.{f}": np.asarray(v, np.float32)
                           for k, v in out.items()
                           if k in ns.get("OUTPUTS", out)})
    mse = {k: float(((v - np.load(ROOT / "tests" / "image_refs" / f"{test}."
                                  f"{k}.npy").astype(np.float32)) ** 2)
                     .mean()) for k, v in images.items()}
    settings = dict(test=test, xla_flags=os.environ["XLA_FLAGS"],
                    seconds=round(time.perf_counter() - t0, 1),
                    mse_vs_golden=mse)
    out_path = OUT_DIR / f"{test}.nofma.npz"
    np.savez_compressed(out_path, settings=np.asarray(json.dumps(settings)),
                        **images)
    print(f"{out_path.relative_to(ROOT)}: MSE against the goldens {mse}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(REFS), default="SVAO_small")
    ap.add_argument("--golden", default=None,
                    help="a golden test's name: render it with XLA's fused "
                         "multiply-adds off")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    if args.golden:
        if "jax" in sys.modules:
            raise SystemExit("--golden: XLA_FLAGS must be set before JAX "
                             "is imported")
        os.environ["XLA_FLAGS"] = " ".join(
            filter(None, (os.environ.get("XLA_FLAGS"), NO_FMA)))
        return golden_without_fma(args.golden)
    import numpy as np
    settings = dict(REFS[args.config])
    settings.update({k: v for k, v in (("width", args.width),
                                       ("height", args.height)) if v})
    t0 = time.perf_counter()
    with reference_branches(settings), raster_overflow() as overflow:
        images, m = render(settings)
    want = {"RayShadow"} | ({"StochasticDepthMap"} if "raster_sd" in settings
                            else set())
    if set(INTERPRETED) != want:
        raise SystemExit(f"Pallas kernels ran in {dict(INTERPRETED)}, not "
                         f"in each of {sorted(want)}")
    settings["seconds"] = round(time.perf_counter() - t0, 1)
    settings["raster_overflow"] = dict(sorted(overflow.items()))
    capped = {p for p in RASTER_PASSES if p in settings["pass_overrides"]}
    if not set(overflow) <= capped or any(overflow.values()):
        raise SystemExit(f"raster overflow {dict(overflow)}; the passes "
                         f"capped at {MAX_PER_TILE}: {sorted(capped)}")
    settings["overflow_at_256"] = gbuffer_overflow(m, settings, 256)
    settings["overflow"] = gbuffer_overflow(m, settings, MAX_PER_TILE)
    if settings["overflow"]:
        raise SystemExit(f"the XLA raster drops {settings['overflow']} "
                         f"entries at maxPerTile {MAX_PER_TILE}")
    path = ref_path(args.config, settings)
    np.savez_compressed(path, settings=np.asarray(json.dumps(settings)),
                        **images)
    print(f"{path.relative_to(ROOT)}: "
          + ", ".join(f"{k} {v.shape}" for k, v in images.items())
          + f"; {settings['seconds']} s; G-buffer overflow at 256: "
          f"{settings['overflow_at_256']}, at {MAX_PER_TILE}: 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
