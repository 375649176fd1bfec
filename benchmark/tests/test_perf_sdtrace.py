"""The reference's stochastic-depth trace (reference/port/ops/
ref_sd_trace.py, its own cull) returns the slots of the program's plain
K7 (a walk of the chunks' lists) bit for bit, on the CPU at small size:
the camera outside the town, among its buildings and low behind a wall."""
import perfutil
import pytest
import torch

from harness import cell
from reference.port.ops import ref_sd_trace
from reference.port.ops import rt_cuda as ref_rt
from reference.port.scene.camera import Camera
from reference.port.scene.scene import scene_from_numpy
from reference.port.utils.math import dot3
from reference.port.utils.sampling import jitter_grid

torch.set_num_threads(2)

POSES = {"outside": ((12.0, 8.0, 12.0), (0.0, 0.0, 0.0)),
         "among": ((3.0, 1.7, 2.0), (10.0, 1.5, 8.0)),
         "low": ((0.5, 0.4, -1.0), (-6.0, 3.0, -4.0))}
W, H, GUARD = 120, 72, 8


def _scene():
    wl = perfutil.load("workloads", "emerald_720p.orbit")
    cfg = perfutil.load("configs", "emerald_720p")
    sc = dict(cfg["scene"], n_buildings=40, n_props=120, trees=30,
              leaves_per_tree=40, extent=30.0, columns=12)
    arrays, camera = cell.inputs(dict(cfg, scene=sc), wl, 4242)
    return scene_from_numpy(arrays, camera, device="cpu", name=sc["name"])


@pytest.mark.parametrize("cull_back", [True, False])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_reference_trace_equals_the_program_plain_trace(pose, cull_back):
    from rtsdm_tpu_torch.ops import rt_cuda as prog_rt
    scene = _scene()
    base = scene.camera
    pos, tgt = POSES[pose]
    cam = Camera.create(position=pos, target=tgt,
                        focal_length=float(base.focal_length),
                        frame_height=float(base.frame_height), aspect=W / H,
                        near_z=float(base.near_z), far_z=float(base.far_z),
                        device="cpu")
    scene = scene.with_camera(cam)
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    signed = torch.stack([px - GUARD, py - GUARD], -1).float()
    origin, dirs = cam.compute_ray_pinhole(
        signed, (W - 2 * GUARD, H - 2 * GUARD),
        jitter=jitter_grid(H, W, True, device="cpu"))
    cos_w = dot3(dirs, cam.camera_w / torch.sqrt(dot3(cam.camera_w,
                                                      cam.camera_w)))
    g = torch.Generator().manual_seed(2)
    tmin = (0.01 + 0.5 * torch.rand(H, W, generator=g)) / cos_w
    tmax = torch.where(torch.rand(H, W, generator=g) < 0.1, -1.0,
                       cam.far_z / cos_w)
    tri_packed, aabb = ref_rt.prep_triangles_packed(scene, True, origin)
    args = (origin, dirs.reshape(-1, 3), tmin.reshape(-1), tmax.reshape(-1),
            cos_w.reshape(-1), cam.near_z, cam.far_z)
    kw = dict(num_samples=4, cull_back=cull_back, mode="default",
              max_count=0)
    ref = ref_sd_trace.sd_trace(scene.positions, tri_packed, *args, **kw)
    prog = prog_rt.sd_trace_resident(tri_packed, aabb, *args, grid=(H, W),
                                     **kw)
    assert int((ref != ref_rt.INVALID).sum()) > ref.numel() // 8
    assert torch.equal(ref, prog)


def test_reference_trace_refuses_what_it_does_not_compute():
    z = torch.zeros(1, 3)
    with pytest.raises(NotImplementedError):
        ref_sd_trace.sd_trace(torch.zeros(1, 3, 3), torch.zeros(1, 128, 16),
                              z[0], z, z[:, 0], z[:, 0], z[:, 0], 0.1, 9.0,
                              mode="kbuffer")
