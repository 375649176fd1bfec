#!/usr/bin/env python3
"""Pass-by-pass comparison of a graph between the JAX package (rtsdm_tpu)
and the port (rtsdm_tpu_torch) at a mid-size reference's settings
(make_refs.py): --config SVAO_small (the default; scripts/SVAO_small.py)
or SVAO_quarter (scripts/SVAO_quarter.py, BASELINE config 4's graph). It
records the intermediate channels the marked outputs depend on,
RayShadow's visibility (one plane a light, taken from the pass, since the
harness crops marked outputs as images), the quarter-res channels
(DownsamplePass's outputs, CompressNormals' and SVAO's, taken whole from
their passes) and the stochastic-depth map SVAO publishes
(ctx.dictionary["SD_MAP"]), so that a difference in the outputs can be
traced to the first pass that shows it. Integer channels (CompressNormals'
packed normals) are compared as the unsigned bit patterns they hold.

    JAX_PLATFORMS=cpu python tests/torch_refs/compare_passes.py save F.npz
            [--config NAME]
        renders through the JAX package on the CPU as make_refs.py renders
        (use_jit=False; RayShadow through the package's accelerator
        branch, make_refs.py: reference_shadows) and writes every channel
        of the config's intermediates in the kept frame, cropped as the harness crops
        marked outputs; with --port, through the port on --device instead
    python tests/torch_refs/compare_passes.py compare F.npz --device cuda
        renders the same through the port (on the card, or with --device
        cpu through the kernels' plain versions; the config is the one
        F.npz records) and prints, channel by
        channel in graph order, the MSE against F.npz, the share of pixels
        that differ at all, by more than 1e-3 and by more than 0.1, and the
        largest difference; --json writes them. Imports no JAX. With
        --substitute, the port's G-buffer and depth-peeling passes
        (the config's `substituted`) hand on the outputs F.npz recorded for them, whole
        (guard band included), in place of their own: what is left of a
        difference then comes from the passes after them.

Neither command is run by the tests.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from make_refs import (QUARTER_SETTINGS, RASTER_SD_SETTINGS,  # noqa: E402
                       SETTINGS)


def _whole(channel):
    """Keep one output of a pass whole (not cropped as the harness crops
    the graph's marked outputs)."""
    return lambda ctx, out: out[channel]


# per config: the channels in graph order (G-buffer, shadows and lighting,
# the SVAO inputs, the AO and the outputs); the channels taken from a pass
# as it runs, {channel: (module of the pass, its class, the pass's name in
# the graph or None for any, what to keep of (ctx, outputs))}; the raster
# passes whose whole outputs are recorded ("raw/<pass>/<channel>") and,
# with --substitute, handed to the port's passes after them
SVAO_SMALL_CHANNELS = [
    "GBufferRaster.depth", "GBufferRaster.posW", "GBufferRaster.normW",
    "GBufferRaster.faceNormalW", "GBufferRaster.mvec",
    "LinearizeDepth.linearDepth", "RayShadow.visibility", "EnvMapPass.color",
    "ForwardLighting.color", "ToneMapper.dst", "DepthPeeling.depth2",
    "LinearizeDepth0.linearDepth", "CompressNormals.normalOut", "SD_MAP",
    "SVAO.ao", "CrossBilateralBlur0.colorOut", "AmbientOcclusion.out",
    "Shaded.out", "AmbientOcclusionTAA.colorOut", "ShadedTAA.colorOut"]
CONFIGS = {
    "SVAO_small": dict(
        settings=SETTINGS,
        intermediates=SVAO_SMALL_CHANNELS,
        captured={
            "RayShadow.visibility": ("lighting", "RayShadow", None,
                                     _whole("visibility")),
            "SD_MAP": ("svao", "SVAO", None,
                       lambda ctx, out: ctx.dictionary["SD_MAP"])},
        substituted=(("gbuffer", "GBufferRaster"),
                     ("depth_chain", "DepthPeeling"))),
    "SVAO_rasterSD": dict(
        settings=RASTER_SD_SETTINGS,
        intermediates=SVAO_SMALL_CHANNELS,
        captured={
            "RayShadow.visibility": ("lighting", "RayShadow", None,
                                     _whole("visibility")),
            "SD_MAP": ("svao", "SVAO", None,
                       lambda ctx, out: ctx.dictionary["SD_MAP"])},
        substituted=(("gbuffer", "GBufferRaster"),
                     ("depth_chain", "DepthPeeling"))),
    "SVAO_quarter": dict(
        settings=QUARTER_SETTINGS,
        intermediates=[
            "GBufferRaster.depth", "GBufferRaster.posW",
            "GBufferRaster.normW", "GBufferRaster.faceNormalW",
            "GBufferRaster.mvec", "LinearizeDepth.linearDepth",
            "RayShadow.visibility", "EnvMapPass.color",
            "ForwardLighting.color", "ToneMapper.dst", "DownZ.output",
            "DownN.output", "DownGZ.output", "CompressNormals.normalOut",
            "SD_MAP", "SVAO.ao", "AOGuidedBlur.out", "AmbientOcclusion.out",
            "Shaded.out", "ShadedTAA.colorOut"],
        captured={
            "RayShadow.visibility": ("lighting", "RayShadow", None,
                                     _whole("visibility")),
            **{f"{name}.output": ("pipeline_misc", "DownsamplePass", name,
                                  _whole("output"))
               for name in ("DownZ", "DownN", "DownGZ")},
            "CompressNormals.normalOut": ("depth_chain", "CompressNormals",
                                          None, _whole("normalOut")),
            "SD_MAP": ("svao", "SVAO", None,
                       lambda ctx, out: ctx.dictionary["SD_MAP"]),
            "SVAO.ao": ("svao", "SVAO", None, _whole("ao"))},
        substituted=(("gbuffer", "GBufferRaster"),))}


def render(pkg, config: str, device=None, substitute: dict | None = None):
    """({channel: array} of the config's kept frame through `pkg`
    ("rtsdm_tpu" or "rtsdm_tpu_torch"), float32 or, for integer channels,
    int64; the whole outputs of its substituted passes in that frame,
    "raw/..."). With `substitute` (such raw outputs), the port's
    substituted passes return those in place of their own."""
    import importlib
    import numpy as np
    cfg = CONFIGS[config]
    settings, intermediates = cfg["settings"], cfg["intermediates"]
    substituted = cfg["substituted"]
    mog = importlib.import_module(f"{pkg}.mogwai")
    kw = dict(use_jit=False) if pkg == "rtsdm_tpu" else dict(device=device)
    m = mog.Renderer(settings["width"], settings["height"], **kw)
    mog.run_script(str(ROOT / settings["script"]), m)
    for name, props in settings["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    for name in intermediates:
        if name not in cfg["captured"]:
            m.active_graph.mark_output(name)
    captured = dict(cfg["captured"], **{
        cls_name: (module, cls_name, None, lambda ctx, out: out)
        for module, cls_name in substituted})
    seen = {name: [] for name in captured}
    by_class = {}
    for name, (module, cls_name, pass_name, keep) in captured.items():
        by_class.setdefault((module, cls_name), []).append(
            (pass_name, keep, seen[name]))
    substituted_classes = {c for _, c in substituted}
    patched = []
    for (module, cls_name), keeps in by_class.items():
        cls = getattr(importlib.import_module(f"{pkg}.passes.{module}"),
                      cls_name)

        def capture(self, ctx, inputs, state=None, _real=cls.execute,
                    _keeps=keeps, _name=cls_name):
            out, st = _real(self, ctx, inputs, state)
            if substitute is not None and _name in substituted_classes:
                import torch
                out = {k: torch.as_tensor(substitute[f"raw/{_name}/{k}"])
                       .to(v.device, v.dtype) for k, v in out.items()}
            for pass_name, keep, kept_list in _keeps:
                if pass_name in (None, self.name):
                    kept_list.append(keep(ctx, out))
            return out, st

        patched.append((cls, cls.execute))
        cls.execute = capture
    try:
        m.loadScene(settings["scene"])
        m.clock.pause()
        for f in range(settings["frames"]):
            m.clock.frame = f
            out = m.renderFrame()
            if f == settings["frame"]:
                kept = dict(out, **{k: v[-1] for k, v in seen.items()})
    finally:
        for cls, real in patched:
            cls.execute = real
    gb = m._render_res()[2]
    vis = kept["RayShadow.visibility"]     # [lights, H, W] -> [h, w, lights]
    kept["RayShadow.visibility"] = vis[:, gb:gb + settings["height"],
                                       gb:gb + settings["width"]]

    def host(name, v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if name == "RayShadow.visibility":
            v = np.moveaxis(v, 0, -1)
        if np.issubdtype(v.dtype, np.integer):
            return v.astype(np.int64) & 0xFFFFFFFF
        return v.astype(np.float32)

    raw = {f"raw/{cls_name}/{k}": np.asarray(
        v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for _, cls_name in substituted
        for k, v in kept[cls_name].items()}
    return {k: host(k, kept[k]) for k in intermediates}, raw


def differences(got: dict, want: dict) -> dict:
    """Per channel of `want`: MSE, shares of pixels differing (at all,
    > 1e-3, > 0.1; the largest difference over a pixel's channels) and the
    largest difference."""
    import numpy as np
    res = {}
    for name in want:
        a, b = got[name], want[name]
        if a.shape != b.shape or a.size == 0:
            res[name] = dict(shape=list(a.shape), want_shape=list(b.shape))
            continue
        d = np.abs(a.astype(np.float64) - b)
        both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
        d[both_inf] = 0.0
        px = d.max(-1) if d.ndim == 3 else d
        res[name] = dict(mse=float((d ** 2).mean()),
                         differ=float((px > 0).mean()),
                         differ_1e3=float((px > 1e-3).mean()),
                         differ_0_1=float((px > 0.1).mean()),
                         max_abs=float(d.max()))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("save", "compare"))
    ap.add_argument("file", type=Path)
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    default="SVAO_small", help="save: the graph to render")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", action="store_true",
                    help="save: render through the port on --device")
    ap.add_argument("--substitute", action="store_true",
                    help="compare: the port's G-buffer and depth-peeling "
                         "passes hand on the file's outputs")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    t0 = time.perf_counter()
    if args.command == "save":
        if args.port:
            made_by = f"port on {args.device}"
            chans, raw = render("rtsdm_tpu_torch", args.config,
                                args.device)
        else:
            os.environ.setdefault("JAX_PLATFORMS", "cpu")
            from make_refs import reference_branches
            made_by = "rtsdm_tpu on the CPU"
            with reference_branches(CONFIGS[args.config]["settings"]):
                chans, raw = render("rtsdm_tpu", args.config)
        np.savez_compressed(args.file, made_by=np.asarray(made_by),
                            config=np.asarray(args.config),
                            settings=np.asarray(json.dumps(
                                CONFIGS[args.config]["settings"])),
                            **chans, **raw)
        print(f"{args.file}: {len(chans)} channels by {made_by}, "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    with np.load(args.file) as f:
        check = json.loads(str(f["settings"]))
        made_by = str(f["made_by"])
        config = str(f["config"]) if "config" in f.files else "SVAO_small"
        want = {k: f[k] for k in CONFIGS[config]["intermediates"]}
        raw = {k: f[k] for k in f.files if k.startswith("raw/")}
    if check != CONFIGS[config]["settings"]:
        raise SystemExit(f"{args.file} was made with {check}")
    got, _ = render("rtsdm_tpu_torch", config, args.device,
                    raw if args.substitute else None)
    res = differences(got, want)
    print(f"{config}: port on {args.device}"
          f"{', rasters substituted' if args.substitute else ''} "
          f"against {args.file.name} ({made_by}; "
          f"{time.perf_counter() - t0:.1f} s)")
    for name, r in res.items():
        print(f"  {name:32s} " + ("shape {shape} vs {want_shape}".format(**r)
              if "shape" in r else
              "MSE {mse:.4g}; pixels differing {differ:.5f}, > 1e-3 "
              "{differ_1e3:.5f}, > 0.1 {differ_0_1:.5f}; max {max_abs:.4g}"
              .format(**r)))
    if args.json:
        args.json.write_text(json.dumps(dict(
            config=config, device=args.device, substitute=args.substitute, against=made_by,
            channels=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
