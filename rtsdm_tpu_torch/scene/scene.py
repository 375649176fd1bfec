"""Scene (counterpart of rtsdm_tpu/scene/scene.py): a flat triangle soup
plus the per-material tables the ray-traced SD pass reads. Only the fields
the SVAO + SD slice reads are carried; lights, textures and animation stay
with the reference package until their passes are ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._build import scenekit_library
from ..utils.math import cross, normalize
from .camera import CAMERA_FIELDS, Camera

ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_MASK = 1

SCENE_FIELDS = ("positions", "normals", "texcoords", "material_id",
                "tri_alpha_mask", "mat_double_sided", "mat_alpha_mode")


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    positions: torch.Tensor         # [T,3,3] world-space vertex positions
    normals: torch.Tensor           # [T,3,3] vertex normals
    texcoords: torch.Tensor         # [T,3,2]
    material_id: torch.Tensor       # [T] int32
    # per-triangle 4x4 alpha-coverage bitmap over barycentric (u, v), bit
    # floor(u*4) + 4*floor(v*4); 0xFFFF = opaque (the baked stand-in for
    # hashed-alpha testing inside traversal, StochasticDepthMapRT.rt.slang)
    tri_alpha_mask: torch.Tensor    # [T] int32
    mat_double_sided: torch.Tensor  # [M] bool
    mat_alpha_mode: torch.Tensor    # [M] int32
    camera: Camera

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]

    @property
    def device(self):
        return self.positions.device

    def face_normals(self):
        """Geometric normals [T,3] (ref VertexData.faceNormalW)."""
        e1 = self.positions[:, 1] - self.positions[:, 0]
        e2 = self.positions[:, 2] - self.positions[:, 0]
        return normalize(cross(e1, e2))


def morton_codes(centroids, bmin, bmax) -> np.ndarray:
    """30-bit 3-D morton codes of float32 centroids [T,3] (scenekit)."""
    lib = scenekit_library()
    c = np.ascontiguousarray(centroids, np.float32)
    lo = np.ascontiguousarray(bmin, np.float32)
    hi = np.ascontiguousarray(bmax, np.float32)
    out = np.empty((c.shape[0],), np.uint32)
    lib.scenekit_morton_codes(c.ctypes.data, c.shape[0], lo.ctypes.data,
                              hi.ctypes.data, out.ctypes.data)
    return out


def make_scene(name, positions, normals=None, texcoords=None,
               material_id=None, materials=None, camera: Camera | None = None,
               morton_sort: bool = True, tri_alpha_mask=None,
               device="cpu") -> Scene:
    """Assemble a Scene from host data (the SceneBuilder equivalent). With
    morton_sort, triangles are ordered along a morton curve of their
    centroids (the BLAS-build analogue: ray-trace chunks become spatially
    tight)."""
    positions = np.asarray(positions, np.float32)
    t = positions.shape[0]
    material_id = (np.zeros((t,), np.int32) if material_id is None
                   else np.asarray(material_id, np.int32))
    if morton_sort and t > 1:
        cent = positions.mean(axis=1)
        order = np.argsort(morton_codes(cent, cent.min(0), cent.max(0)),
                           kind="stable")
        positions, material_id = positions[order], material_id[order]
        if normals is not None:
            normals = np.asarray(normals, np.float32)[order]
        if texcoords is not None:
            texcoords = np.asarray(texcoords, np.float32)[order]
        if tri_alpha_mask is not None:
            tri_alpha_mask = np.asarray(tri_alpha_mask, np.int32)[order]

    materials = materials or [dict(base_color=(0.8, 0.8, 0.8))]
    dbl = np.asarray([bool(m.get("double_sided", False)) for m in materials])
    amode = np.asarray([m.get("alpha_mode", ALPHA_MODE_OPAQUE)
                        for m in materials], np.int32)
    opac = np.asarray([m.get("opacity", 1.0) for m in materials], np.float32)
    if tri_alpha_mask is None:
        # constant-opacity materials: all-ones when opacity >= 0.5 (opaque or
        # surviving hashed-alpha), all-zeros otherwise
        keep = (amode[material_id] == ALPHA_MODE_OPAQUE) \
            | (opac[material_id] >= 0.5)
        tri_alpha_mask = np.where(keep, 0xFFFF, 0).astype(np.int32)

    pos = torch.as_tensor(positions, device=device)
    if normals is None:
        fn = normalize(cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]))
        nrm = fn[:, None, :].expand(t, 3, 3).contiguous()
    else:
        nrm = torch.as_tensor(np.asarray(normals, np.float32), device=device)
    tex = (torch.zeros((t, 3, 2), device=device) if texcoords is None
           else torch.as_tensor(np.asarray(texcoords, np.float32),
                                device=device))
    return Scene(
        name=name, positions=pos, normals=nrm, texcoords=tex,
        material_id=torch.as_tensor(material_id, device=device),
        tri_alpha_mask=torch.as_tensor(
            np.asarray(tri_alpha_mask, np.int32), device=device),
        mat_double_sided=torch.as_tensor(dbl, device=device),
        mat_alpha_mode=torch.as_tensor(amode, device=device),
        camera=camera if camera is not None else Camera.create(device=device))


def scene_from_numpy(arrays: dict, camera: dict, device="cpu",
                     name: str = "scene") -> Scene:
    """Carry a scene across from the reference package: `arrays` holds the
    SCENE_FIELDS and `camera` the CAMERA_FIELDS of an rtsdm_tpu Scene /
    Camera as numpy arrays (np.asarray of each field). Both packages then
    render bit-identical geometry from bit-identical camera matrices."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    cam = Camera(**{f: t(np.asarray(camera[f], np.float32))
                    for f in CAMERA_FIELDS})
    return Scene(name=name, camera=cam,
                 **{f: t(arrays[f]) for f in SCENE_FIELDS})
