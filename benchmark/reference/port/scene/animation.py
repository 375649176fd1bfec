"""Scene animation (counterpart of rtsdm_tpu/scene/animation.py; reference
Scene/Animation/AnimationController.h:43): a keyframed camera path, per-node
keyframed rigid transforms of triangle groups, and linear-blend skinning.

Keyframes are sampled on the host in numpy float32, as in the reference
package; applying the sampled matrices to the triangle soup is tensor code
on the scene's device. Every geometry-derived input of the kernels (K1's
cull boxes and lists, the SD trace's packed triangles and screen rows,
K8's boxes, K2's attribute table) is built from the animated positions of
the frame that reads it, so nothing geometric is kept across frames.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.math import cross
from .camera import Camera


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2 * p1) + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


class CameraPath:
    """Keyframed camera path with Catmull-Rom interpolation. Loops."""

    def __init__(self, positions, targets, ups=None, duration: float = 10.0):
        self.positions = np.asarray(positions, np.float32)
        self.targets = np.asarray(targets, np.float32)
        n = len(self.positions)
        self.ups = (np.asarray(ups, np.float32) if ups is not None
                    else np.tile([0.0, 1.0, 0.0], (n, 1)))
        self.duration = float(duration)

    def _sample(self, arr, u):
        n = len(arr)
        f = (u % 1.0) * n
        i1 = int(f) % n
        i0, i2, i3 = (i1 - 1) % n, (i1 + 1) % n, (i1 + 2) % n
        return _catmull_rom(arr[i0], arr[i1], arr[i2], arr[i3], f - int(f))

    def eval(self, time: float):
        """(position, target, up) at `time`, numpy float32."""
        u = time / self.duration
        return (self._sample(self.positions, u),
                self._sample(self.targets, u),
                self._sample(self.ups, u))

    def camera_at(self, time: float, base: Camera, dt: float = 1 / 60,
                  aspect=None, focal=None) -> Camera:
        """Camera at `time` on the device of `base` (whose lens and clip
        planes it keeps), with last frame's matrices (time - dt) for motion
        vectors."""
        pos, tgt, up = self.eval(time)
        kwargs = dict(
            focal_length=float(focal if focal is not None
                               else base.focal_length),
            frame_height=float(base.frame_height),
            aspect=float(aspect if aspect is not None else base.aspect),
            near_z=float(base.near_z), far_z=float(base.far_z),
            device=base.pos_w.device)
        p_pos, p_tgt, p_up = self.eval(max(time - dt, 0.0))
        prev = Camera.create(position=p_pos, target=p_tgt, up=p_up, **kwargs)
        return Camera.create(position=pos, target=tgt, up=up, prev=prev,
                             **kwargs)

    @staticmethod
    def orbit(center, radius: float, height: float, duration: float = 10.0,
              n: int = 16) -> "CameraPath":
        """Circular flythrough (the benchmark's path for config 5)."""
        center = np.asarray(center, np.float32)
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pos = np.stack([center[0] + radius * np.cos(ang),
                        np.full(n, center[1] + height),
                        center[2] + radius * np.sin(ang)], -1)
        tgt = np.tile(center, (n, 1))
        return CameraPath(pos, tgt, duration=duration)


def _quat_slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _quat_to_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class NodeTrack:
    """Keyframed TRS track for one node (Animation::Keyframe: time,
    translation, scaling, rotation quaternion). Linear T/S, slerp R; loops."""

    def __init__(self, keyframes):
        """keyframes: list of dicts {time, translation(3), rotation(quat
        xyzw, optional), scaling(3, optional)} sorted by time."""
        self.times = np.asarray([k["time"] for k in keyframes], np.float64)
        self.trans = np.asarray([k.get("translation", (0, 0, 0))
                                 for k in keyframes], np.float32)
        self.rots = np.asarray([k.get("rotation", (0, 0, 0, 1))
                                for k in keyframes], np.float32)
        self.scales = np.asarray([k.get("scaling", (1, 1, 1))
                                  for k in keyframes], np.float32)
        self.duration = float(self.times[-1]) if len(keyframes) > 1 else 1.0

    def sample(self, time: float) -> np.ndarray:
        """4x4 node-to-world matrix at `time` (looping)."""
        if len(self.times) == 1:
            i0 = i1 = 0
            f = 0.0
        else:
            t = time % self.duration
            i1 = int(np.searchsorted(self.times, t, side="right"))
            i1 = min(max(i1, 1), len(self.times) - 1)
            i0 = i1 - 1
            span = float(self.times[i1] - self.times[i0]) or 1.0
            f = float((t - self.times[i0]) / span)
        tr = (1 - f) * self.trans[i0] + f * self.trans[i1]
        sc = (1 - f) * self.scales[i0] + f * self.scales[i1]
        r = _quat_to_mat(_quat_slerp(self.rots[i0], self.rots[i1], f))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = r * sc[None, :]
        m[:3, 3] = tr
        return m

    @staticmethod
    def spin_y(center, period: float, n: int = 8) -> "NodeTrack":
        """Continuous yaw rotation about `center`."""
        kf = []
        for i in range(n + 1):
            ang = 2 * np.pi * i / n
            q = (0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2))
            c = np.asarray(center, np.float32)
            r = _quat_to_mat(np.asarray(q, np.float32))
            kf.append(dict(time=period * i / n,
                           translation=tuple(c - r @ c), rotation=q))
        return NodeTrack(kf)

    @staticmethod
    def oscillate(axis, amplitude: float, period: float,
                  n: int = 16) -> "NodeTrack":
        """Sinusoidal translation along `axis`."""
        kf = []
        a = np.asarray(axis, np.float32)
        for i in range(n + 1):
            ph = 2 * np.pi * i / n
            kf.append(dict(time=period * i / n,
                           translation=tuple(a * amplitude * np.sin(ph))))
        return NodeTrack(kf)


def _rotate(r, v):
    """r [..., 3, 3] times v [..., 3], written as the reference package's
    einsum contracts it on the CPU: row i is r[i,0] v0 + r[i,1] v1 +
    r[i,2] v2, summed left to right (ROADMAP hazard j: no matmul, whose
    order and TF32 the card may choose)."""
    return (r[..., 0] * v[..., 0:1] + r[..., 1] * v[..., 1:2]) \
        + r[..., 2] * v[..., 2:3]


def _unit(v):
    """v / max(|v|, 1e-8) along the last axis, a tensor-by-tensor divide."""
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)),
                           min=1e-8)


class AnimationController:
    """Drives the scene's node_id'd triangle groups along NodeTracks
    (AnimationController::animate). `animate(scene, time)` returns a scene
    whose positions and normals are the animated soup and whose
    prev_positions hold the (time - dt) soup for object motion vectors."""

    def __init__(self, tracks: dict[int, NodeTrack], dt: float = 1 / 60):
        self.tracks = dict(tracks)
        self.dt = float(dt)
        self.n_nodes = max(self.tracks) + 1 if self.tracks else 1

    def node_matrices(self, time: float) -> np.ndarray:
        """[nodes, 4, 4] node-to-world matrices at `time` (float32)."""
        mats = np.tile(np.eye(4, dtype=np.float32), (self.n_nodes, 1, 1))
        for nid, tr in self.tracks.items():
            mats[nid] = tr.sample(time)
        return mats

    def animate(self, scene, time: float):
        """The animated scene at `time`, on the scene's device. `scene`
        must be the bind-pose scene (mogwai.Renderer keeps it): node
        matrices are absolute, not incremental."""
        base = scene.positions
        node = torch.clamp(scene.node_id.long(), 0, self.n_nodes - 1)

        def per_tri(mats):
            return torch.as_tensor(mats, device=base.device)[node]  # [T,4,4]

        def apply(m):
            return _rotate(m[:, None, :3, :3], base) + m[:, None, :3, 3]

        m = per_tri(self.node_matrices(time))
        prev = apply(per_tri(self.node_matrices(max(time - self.dt, 0.0))))
        # shading normals rotate with their node (rigid tracks)
        n = _unit(_rotate(m[:, None, :3, :3], scene.normals))
        return dataclasses.replace(scene, positions=apply(m), normals=n,
                                   prev_positions=prev)


class SkinnedController(AnimationController):
    """Linear-blend skinning (reference Scene/Animation/Skinning.slang:
    boneWeights . boneMats[boneIds] per vertex). tracks map JOINT ids to
    NodeTracks; `bind_inv` are the inverse bind matrices [J,4,4]. Vertices
    carry up to 4 (joint, weight) influences (scene.skin_joints and
    skin_weights [T,3,4]; weight 0 pads); a vertex whose weights are all 0
    stays where it is."""

    def __init__(self, tracks, bind_inv, dt: float = 1 / 60):
        super().__init__(tracks, dt=dt)
        self.bind_inv = np.asarray(bind_inv, np.float32)

    def _skin_mats(self, time: float) -> np.ndarray:
        """[J,4,4] joint-to-world times inverse bind."""
        j = self.bind_inv.shape[0]
        mats = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
        for nid, tr in self.tracks.items():
            if nid < j:
                mats[nid] = tr.sample(time) @ self.bind_inv[nid]
        return mats

    def animate(self, scene, time: float):
        if scene.skin_joints is None:
            return super().animate(scene, time)
        base = scene.positions
        joints = scene.skin_joints.long()
        weights = scene.skin_weights
        wsum = weights.sum(-1)

        def apply(mats):
            m = torch.as_tensor(mats, device=base.device)[joints]
            v = _rotate(m[..., :3, :3], base[:, :, None, :]) + m[..., :3, 3]
            blended = (v * weights[..., None]).sum(2) \
                / torch.clamp(wsum, min=1e-8)[..., None]
            rigid = torch.isclose(wsum, torch.zeros_like(wsum))[..., None]
            return torch.where(rigid, base, blended)

        new_pos = apply(self._skin_mats(time))
        prev_pos = apply(self._skin_mats(max(time - self.dt, 0.0)))
        # face-aligned shading normals of the deformed soup
        fn = _unit(cross(new_pos[:, 1] - new_pos[:, 0],
                         new_pos[:, 2] - new_pos[:, 0]))
        n = fn[:, None, :].expand(new_pos.shape).contiguous()
        return dataclasses.replace(scene, positions=new_pos, normals=n,
                                   prev_positions=prev_pos)
