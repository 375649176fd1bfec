"""Scene (counterpart of rtsdm_tpu/scene/scene.py): a flat triangle soup
plus the material, light, texture and environment tables the passes read,
and the geometry-animation fields scene/animation.py drives (node ids,
previous positions, skinning).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.math import cross, normalize
from .camera import CAMERA_FIELDS, Camera

ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_MASK = 1

# light types (reference Scene/Lights LightType)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1

SCENE_FIELDS = ("positions", "normals", "texcoords", "material_id",
                "tri_alpha_mask", "node_id", "prev_positions", "skin_joints",
                "skin_weights", "mat_base_color", "mat_roughness",
                "mat_metallic", "mat_ior", "mat_emissive", "mat_double_sided",
                "mat_alpha_mode", "mat_opacity", "mat_tex", "light_type",
                "light_pos", "light_dir", "light_intensity", "env_radiance",
                "tex_pages", "env_map")
OPTIONAL_FIELDS = ("prev_positions", "skin_joints", "skin_weights",
                   "tex_pages", "env_map")


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
    # geometry animation (reference AnimationController.h:43): node_id maps
    # triangles to animated nodes (0 = static); prev_positions holds last
    # frame's animated vertices for object motion vectors (None: static)
    node_id: torch.Tensor                 # [T] int32
    prev_positions: torch.Tensor | None   # [T,3,3]
    # linear-blend skinning (reference Skinning.slang): up to 4 (joint,
    # weight) influences a vertex; None = unskinned
    skin_joints: torch.Tensor | None      # [T,3,4] int32
    skin_weights: torch.Tensor | None     # [T,3,4]
    # materials [M, ...] (StandardMaterial metallic workflow)
    mat_base_color: torch.Tensor    # [M,3]
    mat_roughness: torch.Tensor     # [M]
    mat_metallic: torch.Tensor      # [M]
    mat_ior: torch.Tensor           # [M]
    mat_emissive: torch.Tensor      # [M,3]
    mat_double_sided: torch.Tensor  # [M] bool
    mat_alpha_mode: torch.Tensor    # [M] int32
    mat_opacity: torch.Tensor       # [M] constant opacity (alpha-mask mode)
    mat_tex: torch.Tensor           # [M] int32 page index, -1 = none
    # analytic lights [L, ...]
    light_type: torch.Tensor        # [L] int32
    light_pos: torch.Tensor         # [L,3]
    light_dir: torch.Tensor         # [L,3] (directional)
    light_intensity: torch.Tensor   # [L,3]
    env_radiance: torch.Tensor      # [3] constant radiance (a tint with a map)
    tex_pages: torch.Tensor | None  # [N, PAGE, PAGE, 3]; None = untextured
    env_map: torch.Tensor | None    # [He, We, 3] lat-long; None = constant
    camera: Camera

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_type.shape[0]

    @property
    def device(self):
        return self.positions.device

    def with_camera(self, camera: Camera) -> "Scene":
        return dataclasses.replace(self, camera=camera)

    def face_normals(self):
        """Geometric normals [T,3] (ref VertexData.faceNormalW)."""
        e1 = self.positions[:, 1] - self.positions[:, 0]
        e2 = self.positions[:, 2] - self.positions[:, 0]
        return normalize(cross(e1, e2))


def _expand_bits(v):
    """10-bit integers spread to every third bit (uint32 wrapping)."""
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes(centroids, bmin, bmax) -> np.ndarray:
    """30-bit 3-D morton codes of float32 centroids [T,3]: numpy, with the
    float32 operations of the port's compiled helper (rtsdm_tpu/native/
    scenekit.cpp:117-136), so both order triangles alike."""
    c = np.ascontiguousarray(centroids, np.float32)
    lo = np.asarray(bmin, np.float32)
    ext = np.asarray(bmax, np.float32) - lo
    ext = np.where(ext <= 0, np.float32(1.0), ext).astype(np.float32)
    out = np.zeros((c.shape[0],), np.uint32)
    with np.errstate(over="ignore"):
        for k in range(3):
            x = np.clip((c[:, k] - lo[k]) / ext[k], np.float32(0.0),
                        np.float32(1.0))
            q = (x * np.float32(1023.0)).astype(np.uint32)
            out |= _expand_bits(q) << np.uint32(2 - k)
    return out


def _normalize_np(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return v / np.sqrt(np.maximum((v * v).sum(), np.float32(1e-20)))


def make_scene(name, positions, normals=None, texcoords=None,
               material_id=None, materials=None, lights=None,
               env_radiance=(0.0, 0.0, 0.0), camera: Camera | None = None,
               morton_sort: bool = True, tri_alpha_mask=None, env_map=None,
               node_id=None, skin_joints=None, skin_weights=None,
               device="cuda") -> Scene:
    """Assemble a Scene from host data (the SceneBuilder equivalent). With
    morton_sort, triangles are ordered along a morton curve of their
    centroids (the BLAS-build analogue: ray-trace chunks become spatially
    tight). Materials are dicts (base_color, roughness, metallic, ior,
    emissive, double_sided, alpha_mode, opacity, texture: a host image baked
    into the page stack); lights are dicts (type "point" or "directional",
    position, direction, intensity). node_id [T] (default 0: static) and
    the skin's joints and weights [T,3,4] follow their triangles' order.
    On the GPU unless device="cpu"."""
    from .textures import build_texture_pages
    device = resolve_device(device)
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
        if node_id is not None:
            node_id = np.asarray(node_id, np.int32)[order]
        if skin_joints is not None:
            skin_joints = np.asarray(skin_joints, np.int32)[order]
            skin_weights = np.asarray(skin_weights, np.float32)[order]

    materials = materials or [dict(base_color=(0.8, 0.8, 0.8))]
    m = len(materials)
    base = np.zeros((m, 3), np.float32)
    rough = np.full((m,), 0.7, np.float32)
    metal = np.zeros((m,), np.float32)
    ior = np.full((m,), 1.5, np.float32)
    emis = np.zeros((m, 3), np.float32)
    dbl = np.zeros((m,), bool)
    amode = np.zeros((m,), np.int32)
    opac = np.ones((m,), np.float32)
    mtex = np.full((m,), -1, np.int32)
    tex_images = []
    for i, md in enumerate(materials):
        base[i] = md.get("base_color", (0.8, 0.8, 0.8))
        rough[i] = md.get("roughness", 0.7)
        metal[i] = md.get("metallic", 0.0)
        ior[i] = md.get("ior", 1.5)
        emis[i] = md.get("emissive", (0.0, 0.0, 0.0))
        dbl[i] = md.get("double_sided", False)
        amode[i] = md.get("alpha_mode", ALPHA_MODE_OPAQUE)
        opac[i] = md.get("opacity", 1.0)
        if md.get("texture") is not None:
            mtex[i] = len(tex_images)
            tex_images.append(md["texture"])
    tex_pages = build_texture_pages(tex_images)

    lights = lights if lights is not None else []
    nl = max(len(lights), 1)
    ltype = np.zeros((nl,), np.int32)
    lpos = np.zeros((nl, 3), np.float32)
    ldir = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (nl, 1))
    lint = np.zeros((nl, 3), np.float32)
    for i, ld in enumerate(lights):
        ltype[i] = (LIGHT_DIRECTIONAL if ld.get("type", "point")
                    == "directional" else LIGHT_POINT)
        lpos[i] = ld.get("position", (0.0, 0.0, 0.0))
        ldir[i] = _normalize_np(ld.get("direction", (0.0, -1.0, 0.0)))
        lint[i] = ld.get("intensity", (1.0, 1.0, 1.0))
    if env_map is not None and tuple(np.asarray(env_radiance)) == \
            (0.0, 0.0, 0.0):
        env_radiance = (1.0, 1.0, 1.0)  # the tint is identity with a map

    if tri_alpha_mask is None:
        # constant-opacity materials: all-ones when opacity >= 0.5 (opaque or
        # surviving hashed-alpha), all-zeros otherwise
        keep = (amode[material_id] == ALPHA_MODE_OPAQUE) \
            | (opac[material_id] >= 0.5)
        tri_alpha_mask = np.where(keep, 0xFFFF, 0).astype(np.int32)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    pos = dev(positions)
    if normals is None:
        fn = normalize(cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]))
        nrm = fn[:, None, :].expand(t, 3, 3).contiguous()
    else:
        nrm = dev(normals, np.float32)
    tex = (torch.zeros((t, 3, 2), device=device) if texcoords is None
           else dev(texcoords, np.float32))
    return Scene(
        name=name, positions=pos, normals=nrm, texcoords=tex,
        material_id=dev(material_id),
        tri_alpha_mask=dev(tri_alpha_mask, np.int32),
        node_id=dev(np.zeros((t,), np.int32) if node_id is None
                    else node_id, np.int32),
        prev_positions=None,
        skin_joints=None if skin_joints is None else dev(skin_joints,
                                                         np.int32),
        skin_weights=None if skin_weights is None else dev(skin_weights,
                                                           np.float32),
        mat_base_color=dev(base), mat_roughness=dev(rough),
        mat_metallic=dev(metal), mat_ior=dev(ior), mat_emissive=dev(emis),
        mat_double_sided=dev(dbl), mat_alpha_mode=dev(amode),
        mat_opacity=dev(opac), mat_tex=dev(mtex),
        light_type=dev(ltype), light_pos=dev(lpos), light_dir=dev(ldir),
        light_intensity=dev(lint),
        env_radiance=dev(env_radiance, np.float32),
        tex_pages=None if tex_pages is None else dev(tex_pages, np.float32),
        env_map=None if env_map is None else dev(env_map, np.float32),
        camera=camera if camera is not None else Camera.create(device=device))


def scene_from_numpy(arrays: dict, camera: dict, device="cuda",
                     name: str = "scene") -> Scene:
    """Carry a scene across from the reference package: `arrays` holds the
    SCENE_FIELDS and `camera` the CAMERA_FIELDS of an rtsdm_tpu Scene /
    Camera as numpy arrays (np.asarray of each field; None for an absent
    OPTIONAL_FIELDS entry). Both packages then render bit-identical
    geometry from bit-identical camera matrices. On the GPU unless
    device="cpu"."""
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=device)

    cam = Camera(**{f: t(np.asarray(camera[f], np.float32))
                    for f in CAMERA_FIELDS})
    return Scene(name=name, camera=cam,
                 **{f: t(arrays.get(f)) for f in SCENE_FIELDS})
