#!/usr/bin/env python3
"""Pass-by-pass comparison of scripts/SVAO_small.py between the JAX package
(rtsdm_tpu) and the port (rtsdm_tpu_torch) at the mid-size references'
settings (make_refs.py: SETTINGS): the intermediate channels the marked
outputs depend on, RayShadow's visibility (one plane a light, taken from
the pass, since the harness crops marked outputs as images) and the
stochastic-depth map SVAO publishes (ctx.dictionary["SD_MAP"]), so that a
difference in the outputs can be traced to the first pass that shows it.
Integer channels (CompressNormals' packed normals) are compared as the
unsigned bit patterns they hold.

    JAX_PLATFORMS=cpu python tests/torch_refs/compare_passes.py save F.npz
        renders through the JAX package on the CPU as make_refs.py renders
        (use_jit=False; RayShadow through the package's accelerator
        branch, make_refs.py: reference_shadows) and writes every channel
        of INTERMEDIATES of the kept frame, cropped as the harness crops
        marked outputs; with --port, through the port on --device instead
    python tests/torch_refs/compare_passes.py compare F.npz --device cuda
        renders the same through the port (on the card, or with --device
        cpu through the kernels' plain versions) and prints, channel by
        channel in graph order, the MSE against F.npz, the share of pixels
        that differ at all, by more than 1e-3 and by more than 0.1, and the
        largest difference; --json writes them. Imports no JAX. With
        --substitute, the port's G-buffer and depth-peeling passes
        (SUBSTITUTED) hand on the outputs F.npz recorded for them, whole
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
from make_refs import SETTINGS  # noqa: E402

# in graph order: G-buffer, shadows and lighting, the SVAO inputs, the AO
# and the outputs
INTERMEDIATES = [
    "GBufferRaster.depth", "GBufferRaster.posW", "GBufferRaster.normW",
    "GBufferRaster.faceNormalW", "GBufferRaster.mvec",
    "LinearizeDepth.linearDepth", "RayShadow.visibility", "EnvMapPass.color",
    "ForwardLighting.color", "ToneMapper.dst", "DepthPeeling.depth2",
    "LinearizeDepth0.linearDepth", "CompressNormals.normalOut", "SD_MAP",
    "SVAO.ao", "CrossBilateralBlur0.colorOut", "AmbientOcclusion.out",
    "Shaded.out", "AmbientOcclusionTAA.colorOut", "ShadedTAA.colorOut"]
# channels taken from a pass as it runs: (module of the pass, its class,
# what to keep of (ctx, outputs))
CAPTURED = {
    "RayShadow.visibility": ("lighting", "RayShadow",
                             lambda ctx, out: out["visibility"]),
    "SD_MAP": ("svao", "SVAO", lambda ctx, out: ctx.dictionary["SD_MAP"])}
# the raster passes whose whole outputs are recorded ("raw/<pass>/<channel>")
# and, with --substitute, handed to the port's passes after them
SUBSTITUTED = (("gbuffer", "GBufferRaster"), ("depth_chain", "DepthPeeling"))


def render(pkg, device=None, substitute: dict | None = None):
    """({channel: array} of SETTINGS' kept frame through `pkg` ("rtsdm_tpu"
    or "rtsdm_tpu_torch"), float32 or, for integer channels, int64; the
    whole outputs of SUBSTITUTED's passes in that frame, "raw/..."). With
    `substitute` (such raw outputs), the port's SUBSTITUTED passes return
    those in place of their own."""
    import importlib
    import numpy as np
    mog = importlib.import_module(f"{pkg}.mogwai")
    kw = dict(use_jit=False) if pkg == "rtsdm_tpu" else dict(device=device)
    m = mog.Renderer(SETTINGS["width"], SETTINGS["height"], **kw)
    mog.run_script(str(ROOT / SETTINGS["script"]), m)
    for name, props in SETTINGS["pass_overrides"].items():
        m.active_graph.get_pass(name).cfg.update(props)
    for name in INTERMEDIATES:
        if name not in CAPTURED:
            m.active_graph.mark_output(name)
    raster = [(module, cls_name, lambda ctx, out: out)
              for module, cls_name in SUBSTITUTED]
    captured = dict(CAPTURED, **{cls_name: r for r, (_, cls_name) in
                                 zip(raster, SUBSTITUTED)})
    seen = {name: [] for name in captured}
    patched = []
    for name, (module, cls_name, keep) in captured.items():
        cls = getattr(importlib.import_module(f"{pkg}.passes.{module}"),
                      cls_name)

        def capture(self, ctx, inputs, state=None, _real=cls.execute,
                    _keep=keep, _seen=seen[name], _name=cls_name):
            out, st = _real(self, ctx, inputs, state)
            if substitute is not None and _name in dict(
                    (c, m) for m, c in SUBSTITUTED):
                import torch
                out = {k: torch.as_tensor(substitute[f"raw/{_name}/{k}"])
                       .to(v.device, v.dtype) for k, v in out.items()}
            _seen.append(_keep(ctx, out))
            return out, st

        patched.append((cls, cls.execute))
        cls.execute = capture
    try:
        m.loadScene(SETTINGS["scene"])
        m.clock.pause()
        for f in range(SETTINGS["frames"]):
            m.clock.frame = f
            out = m.renderFrame()
            if f == SETTINGS["frame"]:
                kept = dict(out, **{k: v[-1] for k, v in seen.items()})
    finally:
        for cls, real in patched:
            cls.execute = real
    gb = m._render_res()[2]
    vis = kept["RayShadow.visibility"]     # [lights, H, W] -> [h, w, lights]
    kept["RayShadow.visibility"] = vis[:, gb:gb + SETTINGS["height"],
                                       gb:gb + SETTINGS["width"]]

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
        for _, cls_name in SUBSTITUTED
        for k, v in kept[cls_name].items()}
    return {k: host(k, kept[k]) for k in INTERMEDIATES}, raw


def differences(got: dict, want: dict) -> dict:
    """Per channel: MSE, shares of pixels differing (at all, > 1e-3,
    > 0.1; the largest difference over a pixel's channels) and the
    largest difference."""
    import numpy as np
    res = {}
    for name in INTERMEDIATES:
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
            chans, raw = render("rtsdm_tpu_torch", args.device)
        else:
            os.environ.setdefault("JAX_PLATFORMS", "cpu")
            from make_refs import reference_shadows
            made_by = "rtsdm_tpu on the CPU"
            with reference_shadows():
                chans, raw = render("rtsdm_tpu")
        np.savez_compressed(args.file, made_by=np.asarray(made_by),
                            settings=np.asarray(json.dumps(SETTINGS)),
                            **chans, **raw)
        print(f"{args.file}: {len(chans)} channels by {made_by}, "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    with np.load(args.file) as f:
        check = json.loads(str(f["settings"]))
        made_by = str(f["made_by"])
        want = {k: f[k] for k in INTERMEDIATES}
        raw = {k: f[k] for k in f.files if k.startswith("raw/")}
    if check != SETTINGS:
        raise SystemExit(f"{args.file} was made with {check}")
    got, _ = render("rtsdm_tpu_torch", args.device,
                    raw if args.substitute else None)
    res = differences(got, want)
    print(f"port on {args.device}"
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
            device=args.device, substitute=args.substitute, against=made_by,
            channels=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
