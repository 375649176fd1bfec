"""The quality oracle: SSIM of the ray-traced stochastic-depth AO against
SVAO's own brute-force reference mode, per BASELINE configuration
(counterpart of tools/quality_ssim.py; the reference's staging is SVAO
beside SVAO_ref with secondaryDepthMode "Raytraced", scripts/
SVAO_depth.py).

Per configuration, on the G-buffer of the configuration's scene (the full
geometry) at its size:
    ray_sd    = SVAO(secondary StochasticDepth, Ray)        the paper
    raster_sd = SVAO(secondary StochasticDepth, Raster)
    ray_ref   = SVAO(secondary Raytraced, ray budget 1.0)    the reference
    rtao      = RTAO accumulated over --rtao-frames frames  cosine truth
reported: SSIM(ray_sd, ray_ref) (the paper's claim, target >= 0.98),
SSIM(raster_sd, ray_ref), the configuration's own SD implementation
against ray_ref, ray_sd against the accumulated RTAO, the baked alpha test
against none, and the mean absolute difference of ray_sd and ray_ref.
Config 1 (HBAO on CornellBox 256x256) is held against the accumulated
RTAO, as the JAX tool holds it. Config 5 (scripts/SVAO_small.py on
EmeraldSquare@full at 1280x720 along the orbiting camera) reports the
temporal stability of ShadedTAA: the mean SSIM of consecutive frames 4-7
(the JAX tool's target >= 0.9).

The sizes are the JAX tool's: config 1 at 256x256, config 2 at 640x360,
configs 3 and 4 at 480x270 (the Raytraced reference is O(rays x
triangles)). Everything runs in this one process.

    python -m rtsdm_tpu_torch.tools.quality_ssim [--out FILE]
        [--configs NAME ...] [--rtao-frames N] [--device cuda|cpu]

writes FILE (default build/quality_ssim.json, under the ignored build/)
and prints it. A row the port cannot produce yet names the ROADMAP item
it waits for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CONFIGS = [
    dict(name="config2_arcade_720p_rastersd", scene="Arcade@full",
         width=1280, height=720, divisor=4, impl="Raster", ref_scale=2),
    dict(name="config3_suntemple_1080p_raysd_fullres", scene="SunTemple@full",
         width=1920, height=1080, divisor=1, impl="Ray", ref_scale=4),
    dict(name="config4_bistro_1080p_raysd_quarter", scene="Bistro@full",
         width=1920, height=1080, divisor=4, impl="Ray", ref_scale=4),
]
CONFIG1 = "config1_hbao_cornell_256"
CONFIG5 = "config5_shaded_taa_stability"
WAITING = {
    "ssim_pallas_vs_xla_oracle": "waits for ROADMAP queue 1 item 9 (the SD "
                                 "trace's XLA tier, usePallas=False)",
}
TARGET = 0.98
TAA_STABILITY_TARGET = 0.9


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def gbuffer_inputs(scene, w: int, h: int):
    """The G-buffer of `scene` at w x h and SVAO's inputs from it."""
    from ..passes.gbuffer import raster_gbuffer
    from ..utils.math import encode_normal_2x16, normalize, transform_vector
    cam = scene.camera
    g = raster_gbuffer(scene, w, h)
    lin = cam.linearize_depth(g["depth"])
    packed = encode_normal_2x16(
        normalize(transform_vector(cam.view_mat, g["faceNormalW"])))
    return g, {"gbufferDepth": g["depth"], "depth": lin, "depth2": lin,
               "normals": packed}


def accumulated_rtao(scene, g, w: int, h: int, t_hit: float, frames: int):
    """RTAO's ambient averaged over `frames` frames (float64 sum)."""
    import torch
    from ..passes.ao_extra import RTAO
    from ..rendergraph.render_pass import RenderContext
    p = RTAO({"maxAORayTHit": t_hit, "maxTheoreticalTHit": t_hit})
    p.set_scene(scene)
    acc = torch.zeros((h, w), dtype=torch.float64, device=g["posW"].device)
    for f in range(frames):
        ctx = RenderContext(width=w, height=h, scene=scene, frame_index=f,
                            dictionary={"guardBand": 0})
        out, _ = p.execute(ctx, {"wPos": g["posW"],
                                 "faceNormal": g["faceNormalW"]})
        acc += out["ambient"].double()
    return (acc / frames).float()


def run_config(c: dict, device: str, rtao_frames: int) -> dict:
    """One configuration's row (see the module docstring); rtao_frames 0
    leaves the RTAO accumulation out."""
    import torch
    from ..passes.svao import SVAO
    from ..rendergraph.render_pass import RenderContext
    from ..scene.procedural import load_scene
    from ..utils.compare import ssim
    rs = int(c.get("ref_scale", 1))
    w, h = c["width"] // rs, c["height"] // rs
    scene = load_scene(c["scene"], aspect=w / h, device=device)
    g, inputs = gbuffer_inputs(scene, w, h)
    ctx = RenderContext(width=w, height=h, scene=scene,
                        dictionary={"guardBand": 0})
    seconds = {}

    def svao(label, props):
        t0 = time.perf_counter()
        p = SVAO(dict(props, radius=0.2, exponent=2.0))
        p.set_scene(scene)
        out, _ = p.execute(ctx, inputs)
        _sync(device)
        seconds[label] = time.perf_counter() - t0
        return out["ao"]

    # the SD guard band scales with the evaluation size, as in the JAX tool
    gb = max(512 // rs, 64)
    ray = {"secondaryDepthMode": "StochasticDepth",
           "stochasticDepthImpl": "Ray", "stochMapDivisor": c["divisor"],
           "stochMapGuardBand": gb}
    ray_sd = svao("ray_sd", ray)
    raster_sd = svao("raster_sd", {
        "secondaryDepthMode": "StochasticDepth",
        "stochasticDepthImpl": "Raster", "stochMapDivisor": c["divisor"]})
    ray_ref = svao("ray_ref", {"secondaryDepthMode": "Raytraced",
                               "maxRayBudgetFraction": 1.0})
    ray_sd_noalpha = svao("ray_sd_noalpha", dict(ray, alphaTest=False))
    primary_sd = raster_sd if c["impl"] == "Raster" else ray_sd

    def s(a, b):
        return float(ssim(a, b))

    rtao_row = {}
    if rtao_frames:
        t0 = time.perf_counter()
        rtao = accumulated_rtao(scene, g, w, h, 0.2, rtao_frames)
        _sync(device)
        seconds["rtao"] = time.perf_counter() - t0
        rtao_row = {f"ssim_ray_sd_vs_rtao{rtao_frames}": s(ray_sd, rtao)}
    return {
        "scene": c["scene"], "triangles": int(scene.num_triangles),
        "resolution": f"{w}x{h}",
        "ssim_ray_sd_vs_raytraced": s(ray_sd, ray_ref),
        "ssim_pallas_vs_xla_oracle": WAITING["ssim_pallas_vs_xla_oracle"],
        "ssim_raster_sd_vs_raytraced": s(raster_sd, ray_ref),
        "ssim_config_impl_vs_raytraced": s(primary_sd, ray_ref),
        **rtao_row,
        "ssim_alpha_mask_vs_noalpha": s(ray_sd, ray_sd_noalpha),
        "ssim_noalpha_vs_raytraced": s(ray_sd_noalpha, ray_ref),
        "mean_abs_diff_ray_sd_vs_raytraced":
            float(torch.abs(ray_sd - ray_ref).mean()),
        "rtao_frames": rtao_frames, "seconds": seconds,
    }


def run_config1_hbao(device: str, rtao_frames: int) -> dict:
    """Config 1 (HBAO on CornellBox 256x256): SSIM against the accumulated
    RTAO, HBAO having no ray-traced reference mode. The graph feeds HBAO
    deinterleaved linear depth and world normals and reinterleaves its
    output (scripts/HBAO.py)."""
    from ..ops.ao_shift import deinterleave, interleave
    from ..passes.hbao import HBAO
    from ..rendergraph.render_pass import RenderContext
    from ..scene.procedural import cornell_box
    from ..utils.compare import ssim
    w = h = 256
    scene = cornell_box(device=device)
    g, inputs = gbuffer_inputs(scene, w, h)
    ctx = RenderContext(width=w, height=h, scene=scene,
                        dictionary={"guardBand": 0})
    hb = HBAO({"radius": 0.5})
    hb.set_scene(scene)
    out, _ = hb.execute(ctx, {"depth": deinterleave(inputs["depth"]),
                              "normals": g["faceNormalW"]})
    hbao = interleave(out["ambientMap"], h, w)
    rtao = accumulated_rtao(scene, g, w, h, 0.5, rtao_frames)
    return {"triangles": int(scene.num_triangles), "resolution": f"{w}x{h}",
            f"ssim_hbao_vs_rtao{rtao_frames}": float(ssim(hbao, rtao)),
            "rtao_frames": rtao_frames}


def run_config5_taa_stability(device: str, scene: str = "EmeraldSquare@full",
                              width: int = 1280, height: int = 720,
                              frames: int = 8) -> dict:
    """Config 5's temporal stability: scripts/SVAO_small.py along the
    orbiting camera (CameraPath.orbit around (0, 2, 0), radius 45, height
    14, 8 s), the clock playing; the SSIM of each pair of consecutive
    ShadedTAA frames from frame 4 on, and their mean. A flickering
    pipeline scores low."""
    from ..mogwai import Renderer, run_script
    from ..scene.animation import CameraPath
    from ..utils.compare import ssim
    m = Renderer(width=width, height=height, device=device)
    run_script(str(ROOT / "scripts" / "SVAO_small.py"), m)
    m.loadScene(scene)
    m.cameraPath = CameraPath.orbit(center=(0, 2, 0), radius=45.0,
                                    height=14.0, duration=8.0)
    m.clock.play()
    kept = []
    for f in range(frames):
        out = m.renderFrame()
        if f >= 4:
            kept.append(out["ShadedTAA.colorOut"][..., :3])
    sims = [float(ssim(a, b)) for a, b in zip(kept, kept[1:])]
    return {"scene": scene, "triangles": int(m.scene.num_triangles),
            "resolution": f"{width}x{height}",
            "consecutive_frame_ssim": sims,
            "mean_frame_ssim": sum(sims) / len(sims),
            "target": TAA_STABILITY_TARGET}


def main(argv=None) -> int:
    import torch
    names = [CONFIG1] + [c["name"] for c in CONFIGS] + [CONFIG5]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "quality_ssim.json")
    ap.add_argument("--configs", nargs="*", default=names, choices=names)
    ap.add_argument("--rtao-frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("quality_ssim: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 1
    report = {"device": (torch.cuda.get_device_name(0)
                         if torch.device(device).type == "cuda" else "cpu"),
              "target": f"ssim_ray_sd_vs_raytraced >= {TARGET}",
              "configs": {}}
    for name in args.configs:
        t0 = time.perf_counter()
        if name == CONFIG1:
            row = run_config1_hbao(device, args.rtao_frames)
        elif name == CONFIG5:
            row = run_config5_taa_stability(device)
        else:
            (c,) = [c for c in CONFIGS if c["name"] == name]
            row = run_config(c, device, args.rtao_frames)
        row["total_seconds"] = time.perf_counter() - t0
        report["configs"][name] = row
        print(name, json.dumps(row), flush=True)
    vals = [v["ssim_ray_sd_vs_raytraced"] for v in report["configs"].values()
            if isinstance(v.get("ssim_ray_sd_vs_raytraced"), float)]
    report["min_ssim_ray_sd_vs_raytraced"] = min(vals) if vals else None
    report["ok"] = bool(vals) and min(vals) >= TARGET
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "configs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
