"""Material-property fetch (counterpart of rtsdm_tpu/ops/materials.py).

The reference fetches every shading property with one one-hot [P, M] @
[M, K] matrix product, a TPU workaround for its slow per-pixel gathers; a
one-hot product at full precision picks table rows exactly, so plain
indexing gives identical values.
"""
from __future__ import annotations


def fetch_shading_materials(scene, mid):
    """StandardMaterial shading properties for an int32 material-id field
    `mid` of any shape: base_color/emissive [..., 3], roughness/metallic/
    ior [...], tex [...] int32 page index."""
    mid = mid.long()
    return dict(base_color=scene.mat_base_color[mid],
                emissive=scene.mat_emissive[mid],
                roughness=scene.mat_roughness[mid],
                metallic=scene.mat_metallic[mid],
                ior=scene.mat_ior[mid],
                tex=scene.mat_tex[mid])


def fetch_material_scalar(table_1d, mid):
    """One per-material scalar (e.g. the double-sided flag) for an id field
    `mid` of any shape, in the table's dtype."""
    return table_1d[mid.long()]
