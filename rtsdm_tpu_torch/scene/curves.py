"""Curve geometry and animated vertex caches (counterpart of
rtsdm_tpu/scene/curves.py; reference Scene/Animation/AnimatedVertexCache.h:
per-keyframe vertex buffers, linear between time samples, looped; and
UpdateCurvePolyTubeVertices.slang: curve strands tessellated into
poly-tubes each frame).

Topology is fixed at import, as the reference assumes
(AnimatedVertexCache.h:57): a frame re-evaluates vertex positions only, by
one lerp of the bracketing keyframes (resolved on the host, as
NodeTrack.sample does) and, for curves, one vectorized tessellation.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.math import cross, true_div
from .animation import AnimationController, _unit


def curve_frames(points):
    """Per-ring orthonormal frames of strands [S, N, 3]: (tangent, normal,
    binormal), each [S, N, 3]. Tangents by central differences (the ends
    one-sided); the normal seeds from +y, or +x where the tangent is
    within 0.99 of y, so a strand's frames move continuously with it."""
    t = torch.cat([points[:, 1:2] - points[:, 0:1],
                   points[:, 2:] - points[:, :-2],
                   points[:, -1:] - points[:, -2:-1]], 1)
    t = _unit(t)
    up = torch.tensor([0.0, 1.0, 0.0], device=points.device)
    alt = torch.tensor([1.0, 0.0, 0.0], device=points.device)
    # t . up is t's y component
    seed = torch.where((torch.abs(t[..., 1]) > 0.99)[..., None], alt, up)
    n = _unit(cross(t, seed))
    return t, n, cross(t, n)


def poly_tube_mesh(points, radii, sides: int = 4):
    """Tessellate strands [S, N, 3] into a poly-tube triangle soup
    (UpdateCurvePolyTubeVertices.slang's vertex rule): radii [N] or [S, N]
    per ring, `sides` vertices a ring. Returns [S*(N-1)*sides*2, 3, 3]; the
    topology depends on (S, N, sides) only."""
    s, n, _ = points.shape
    radii = torch.as_tensor(radii, dtype=torch.float32,
                            device=points.device).expand(s, n)
    _, nrm, bin_ = curve_frames(points)
    ang = true_div(torch.arange(sides, dtype=torch.float32,
                                device=points.device), sides) \
        * (2.0 * math.pi)
    ca, sa = torch.cos(ang), torch.sin(ang)
    # ring vertices [S, N, sides, 3]
    ring = (points[:, :, None, :]
            + radii[..., None, None] * (ca[None, None, :, None]
                                        * nrm[:, :, None, :]
                                        + sa[None, None, :, None]
                                        * bin_[:, :, None, :]))
    a, b = ring[:, :-1], ring[:, 1:]              # [S, N-1, sides, 3]
    a_n, b_n = torch.roll(a, -1, 2), torch.roll(b, -1, 2)
    # two triangles a quad, outward winding
    tris = torch.cat([torch.stack([a, b, a_n], 3),
                      torch.stack([a_n, b, b_n], 3)], 3)
    return tris.reshape(s * (n - 1) * sides * 2, 3, 3)


def poly_tube_tri_count(s: int, n: int, sides: int = 4) -> int:
    return s * (n - 1) * sides * 2


class _Cache:
    """One cached target: the keyframe bracket shared by mesh and curve
    caches (AnimatedVertexCache::interpolate: linear between time samples,
    looped)."""

    def __init__(self, time_samples, t0: int):
        self.times = np.asarray(time_samples, np.float64)
        self.t0 = int(t0)      # first triangle of the target range
        self.duration = float(self.times[-1]) if len(self.times) > 1 else 1.0

    def bracket(self, time: float):
        if len(self.times) == 1:
            return 0, 0, 0.0
        t = time % self.duration
        i1 = int(np.searchsorted(self.times, t, side="right"))
        i1 = min(max(i1, 1), len(self.times) - 1)
        i0 = i1 - 1
        span = float(self.times[i1] - self.times[i0]) or 1.0
        return i0, i1, float((t - self.times[i0]) / span)

    def _lerp(self, time: float, device):
        i0, i1, f = self.bracket(time)
        device = resolve_device(device)
        return (1.0 - f) * torch.as_tensor(self.data[i0], device=device) \
            + f * torch.as_tensor(self.data[i1], device=device)


class CachedMeshTrack(_Cache):
    """CachedMesh: per-keyframe triangle-soup positions [K, T, 3, 3] of the
    scene's triangles [t0, t0+T) (AnimatedVertexCache.h:64-72)."""

    def __init__(self, time_samples, t0: int, vertex_data):
        super().__init__(time_samples, t0)
        self.data = np.asarray(vertex_data, np.float32)
        if self.data.ndim != 4 or len(self.times) != self.data.shape[0]:
            raise ValueError("CachedMeshTrack: vertex_data must be [K, T, 3, "
                             "3] with one entry per time sample")

    @property
    def tri_count(self) -> int:
        return self.data.shape[1]

    def positions(self, time: float, device="cuda"):
        """[T, 3, 3] at `time`, on the GPU unless device="cpu"."""
        return self._lerp(time, device)


class CachedCurveTrack(_Cache):
    """CachedCurve: per-keyframe strand control points [K, S, N, 3],
    re-tessellated into a tube each frame (AnimatedVertexCache.h:47-62 and
    UpdateCurvePolyTubeVertices.slang)."""

    def __init__(self, time_samples, t0: int, strand_data, radii,
                 sides: int = 4):
        super().__init__(time_samples, t0)
        self.data = np.asarray(strand_data, np.float32)
        if self.data.ndim != 4 or len(self.times) != self.data.shape[0]:
            raise ValueError("CachedCurveTrack: strand_data must be [K, S, "
                             "N, 3] with one entry per time sample")
        self.radii = np.asarray(radii, np.float32)
        self.sides = int(sides)

    @property
    def tri_count(self) -> int:
        _, s, n, _ = self.data.shape
        return poly_tube_tri_count(s, n, self.sides)

    def positions(self, time: float, device="cuda"):
        """The tube's [tri_count, 3, 3] at `time`, on the GPU unless
        device="cpu"."""
        return poly_tube_mesh(self._lerp(time, device), self.radii,
                              self.sides)


class VertexCacheController(AnimationController):
    """AnimatedVertexCache: cached mesh and curve triangle ranges of a
    scene, composed with TRS node tracks for the rest (the reference's
    AnimationController owns both). Each frame a cache's positions replace
    its triangle range of the soup, and the range's normals become the
    deformed faces' normals. The scene's tensors are not written."""

    def __init__(self, caches, tracks=None, dt: float = 1 / 60):
        super().__init__(tracks or {}, dt=dt)
        self.caches = list(caches)

    def _apply(self, positions, time):
        positions = positions.clone()
        for cache in self.caches:
            new = cache.positions(time, positions.device)
            positions[cache.t0:cache.t0 + new.shape[0]] = new
        return positions

    def animate(self, scene, time: float):
        if self.tracks:
            scene = super().animate(scene, time)
        pos = self._apply(scene.positions, time)
        prev = self._apply(scene.positions if scene.prev_positions is None
                           else scene.prev_positions,
                           max(time - self.dt, 0.0))
        normals = scene.normals.clone()
        for cache in self.caches:
            p = pos[cache.t0:cache.t0 + cache.tri_count]
            fn = _unit(cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]))
            normals[cache.t0:cache.t0 + cache.tri_count] = \
                fn[:, None, :].expand(p.shape)
        return dataclasses.replace(scene, positions=pos, normals=normals,
                                   prev_positions=prev)
