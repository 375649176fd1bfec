"""Camera (counterpart of rtsdm_tpu/scene/camera.py), mirroring Falcor's
CameraData (CameraData.slang:35-69) so the UVToViewSpace / computeRayPinhole
math transfers verbatim (SVAO/Common.slang:139-153, Camera.slang:46-90).

Every field is a float32 tensor on the camera's device; scalars are 0-d.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.device import device_constant, resolve_device
from ..utils.math import cross, look_at, normalize, perspective

CAMERA_FIELDS = ("view_mat", "prev_view_mat", "proj_mat", "view_proj_mat",
                 "view_proj_no_jitter", "prev_view_proj_no_jitter", "pos_w",
                 "prev_pos_w", "up", "target", "camera_u", "camera_v",
                 "camera_w", "focal_length", "frame_height", "frame_width",
                 "aspect", "near_z", "far_z", "jitter_x", "jitter_y")


@dataclasses.dataclass(frozen=True)
class Camera:
    view_mat: torch.Tensor                 # [4,4]
    prev_view_mat: torch.Tensor            # [4,4]
    proj_mat: torch.Tensor                 # [4,4]
    view_proj_mat: torch.Tensor            # [4,4]
    view_proj_no_jitter: torch.Tensor      # [4,4]
    prev_view_proj_no_jitter: torch.Tensor  # [4,4]
    pos_w: torch.Tensor                    # [3]
    prev_pos_w: torch.Tensor               # [3]
    up: torch.Tensor                       # [3]
    target: torch.Tensor                   # [3]
    camera_u: torch.Tensor                 # [3] right image-plane basis
    camera_v: torch.Tensor                 # [3] up image-plane basis
    camera_w: torch.Tensor                 # [3] forward (unit length)
    focal_length: torch.Tensor             # mm
    frame_height: torch.Tensor             # mm
    frame_width: torch.Tensor              # mm
    aspect: torch.Tensor
    near_z: torch.Tensor
    far_z: torch.Tensor
    jitter_x: torch.Tensor                 # subpixel offset / width
    jitter_y: torch.Tensor                 # subpixel offset / height

    @staticmethod
    def create(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
               up=(0.0, 1.0, 0.0), focal_length=21.0, frame_height=24.0,
               aspect=1.0, near_z=0.1, far_z=1000.0, jitter=(0.0, 0.0),
               prev=None, device="cuda") -> "Camera":
        """Camera::calculateCameraParameters: fovY = 2 atan(frameHeight /
        (2 focalLength)); cameraU/V/W are the computeRayPinhole basis.
        `prev`, last frame's Camera, gives the prev view, prev no-jitter
        view-projection and prev position (motion vectors); without it
        they are this frame's. On the GPU unless device="cpu"
        (utils/device.py). The camera is evaluated on the host and then
        moved: CUDA's arctan, tan and 4x4 products round otherwise than
        the CPU's in the last bit, and the rays and rasters of every pass
        start here."""
        device = resolve_device(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32)

        pos, tgt, upv = f32(position), f32(target), f32(up)
        focal_length, frame_height = f32(focal_length), f32(frame_height)
        aspect, near_z, far_z = f32(aspect), f32(near_z), f32(far_z)

        fov_y = 2.0 * torch.arctan(0.5 * frame_height / focal_length)
        w = normalize(tgt - pos)
        u = normalize(cross(w, upv)) * torch.tan(fov_y * 0.5) * aspect
        v = normalize(cross(u, w)) * torch.tan(fov_y * 0.5)

        view = look_at(pos, tgt, upv)
        proj = perspective(fov_y, aspect, near_z, far_z)
        vp = proj @ view
        host = dict(
            view_mat=view, prev_view_mat=view, proj_mat=proj,
            view_proj_mat=vp, view_proj_no_jitter=vp,
            prev_view_proj_no_jitter=vp, pos_w=pos, prev_pos_w=pos,
            up=upv, target=tgt, camera_u=u, camera_v=v, camera_w=w,
            focal_length=focal_length, frame_height=frame_height,
            frame_width=frame_height * aspect, aspect=aspect,
            near_z=near_z, far_z=far_z,
            jitter_x=f32(jitter[0]), jitter_y=f32(jitter[1]))
        cam = {k: t.to(device) for k, t in host.items()}
        if prev is not None:
            cam.update(prev_view_mat=prev.view_mat,
                       prev_view_proj_no_jitter=prev.view_proj_no_jitter,
                       prev_pos_w=prev.pos_w)
        return Camera(**cam)

    # ------------------------------------------------------------------
    # the shared view <-> uv math of the AO shaders
    # ------------------------------------------------------------------
    def image_scale(self):
        """0.5 * (frameWidth, frameHeight) / focalLength (Common.slang:142)."""
        return 0.5 * torch.stack([self.frame_width / self.focal_length,
                                  self.frame_height / self.focal_length])

    def uv_to_view_space(self, uv, view_depth):
        """uv [..., 2] in [0, 1], positive view depth [...] -> view position
        [..., 3] with negative z (SVAO/Common.slang:139-144)."""
        ndc = torch.stack([uv[..., 0], 1.0 - uv[..., 1]], -1) * 2.0 - 1.0
        xy = ndc * view_depth[..., None] * self.image_scale()
        return torch.cat([xy, -view_depth[..., None]], -1)

    def view_space_to_uv(self, pos_v):
        """View position [..., 3] (negative z) -> uv [..., 2]
        (SVAO/Common.slang:148-153)."""
        ndc = pos_v[..., :2] / (self.image_scale() * pos_v[..., 2:3])
        return ndc * device_constant((-0.5, 0.5), torch.float32,
                                     ndc.device) + 0.5

    def view_space_radius_to_uv_radius(self, z, r: float):
        """Positive view depth z [...], world radius r -> uv radius
        [..., 2] (SVAO/Common.slang:247-253)."""
        fw = torch.stack([self.frame_width, self.frame_height])
        return (r * self.focal_length)[..., None] / (fw * z[..., None])

    def compute_ray_pinhole(self, pixel_xy, frame_dim, jitter=None):
        """Camera rays (Camera.slang:46-90). pixel_xy [..., 2] pixel coords
        (origin top-left); frame_dim (W, H); jitter None -> the camera
        jitter, else an explicit [..., 2] subtexel position in [0, 1].
        Returns (origin [3], normalized directions [..., 3])."""
        wh = device_constant(tuple(float(v) for v in frame_dim),
                             torch.float32, pixel_xy.device)
        if jitter is None:
            p = (pixel_xy + 0.5) / wh + torch.stack([-self.jitter_x,
                                                     self.jitter_y])
        else:
            p = (pixel_xy + jitter) / wh
        ndc_x = 2.0 * p[..., 0:1] - 1.0
        ndc_y = -2.0 * p[..., 1:2] + 1.0
        d = ndc_x * self.camera_u + ndc_y * self.camera_v + self.camera_w
        return self.pos_w, normalize(d)

    def linearize_depth(self, nonlinear):
        """D3D [0, 1] depth -> positive linear view depth
        (LinearizeDepth/Linearize.ps.slang:14)."""
        return self.near_z * self.far_z / (
            self.far_z + nonlinear * (self.near_z - self.far_z))
