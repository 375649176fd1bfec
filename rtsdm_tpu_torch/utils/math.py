"""Math helpers (counterpart of rtsdm_tpu/utils/math.py) on torch tensors.

Conventions are the reference package's: right-handed world, +y up; view
space looks down -z; uv origin top-left; D3D-style NDC depth in [0, 1].

Small fixed-size contractions (cross products, 3- and 4-term dots, matrix
applications) are written out term by term, left to right, so the CPU and
the GPU evaluate the same rounded operations in the same order.
"""
from __future__ import annotations

import torch


def dot3(a, b):
    """a.b over the last axis of length 3, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def true_div(a, b: float):
    """a / b as a correctly rounded float32 division. PyTorch divides a CUDA
    tensor by a Python number as a multiply by its reciprocal, which misses
    the true quotient by an ulp on some inputs; a divisor tensor on the same
    device keeps the IEEE division the CPU and the kernels perform."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def normalize(v, eps=1e-20):
    """v / |v| over the last axis (length 3)."""
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=eps))[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def look_at(eye, target, up):
    """Right-handed view matrix [4, 4] float32; view space looks down -z."""
    f = normalize(target - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    m = torch.zeros((4, 4), dtype=torch.float32, device=eye.device)
    m[0, :3], m[0, 3] = s, -dot3(s, eye)
    m[1, :3], m[1, 3] = u, -dot3(u, eye)
    m[2, :3], m[2, 3] = -f, dot3(f, eye)
    m[3, 3] = 1.0
    return m


def perspective(fov_y, aspect, near, far):
    """Right-handed perspective with depth mapped to [0, 1] (D3D ZO):
    view z = -near -> 0, view z = -far -> 1."""
    f = 1.0 / torch.tan(fov_y * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32, device=fov_y.device)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def transform_point(m, p):
    """Apply a 4x4 matrix to 3-d points [..., 3] -> homogeneous [..., 4]."""
    return torch.stack([p[..., 0] * m[j, 0] + p[..., 1] * m[j, 1]
                        + p[..., 2] * m[j, 2] + m[j, 3] for j in range(4)], -1)


def transform_vector(m, v):
    """Apply the upper-left 3x3 of a 4x4 (or a 3x3) matrix to [..., 3]."""
    return torch.stack([v[..., 0] * m[j, 0] + v[..., 1] * m[j, 1]
                        + v[..., 2] * m[j, 2] for j in range(3)], -1)


# ---------------------------------------------------------------------------
# Octahedral normal packing (reference PackedFormats encodeNormal2x16). A
# packed normal is an int32 tensor holding the uint32 bit pattern.
# ---------------------------------------------------------------------------

def _oct_wrap(v):
    sign = torch.where(v >= 0.0, 1.0, -1.0)
    return (1.0 - torch.abs(v.flip(-1))) * sign


def ndir_to_oct_snorm(n):
    """Unit vector [..., 3] -> octahedral [-1, 1]^2."""
    inv = 1.0 / (torch.abs(n[..., 0:1]) + torch.abs(n[..., 1:2])
                 + torch.abs(n[..., 2:3]))
    p = n[..., :2] * inv
    return torch.where(n[..., 2:3] < 0.0, _oct_wrap(p), p)


def oct_snorm_to_ndir(p):
    """Octahedral [-1, 1]^2 -> unit vector [..., 3]."""
    z = 1.0 - torch.abs(p[..., 0]) - torch.abs(p[..., 1])
    xy = torch.where(z[..., None] < 0.0, _oct_wrap(p), p)
    return normalize(torch.cat([xy, z[..., None]], -1))


def encode_normal_2x16(n):
    """Unit normal [..., 3] -> int32 [...] (uint32 bits: x | y << 16)."""
    p = ndir_to_oct_snorm(n)
    u = torch.round((p * 0.5 + 0.5) * 65535.0).to(torch.int64)
    packed = u[..., 0] | (u[..., 1] << 16)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def decode_normal_2x16(packed):
    """int32 [...] (uint32 bits) -> unit normal [..., 3]."""
    x = (packed & 0xFFFF).to(torch.float32) / 65535.0 * 2.0 - 1.0
    y = ((packed >> 16) & 0xFFFF).to(torch.float32) / 65535.0 * 2.0 - 1.0
    return oct_snorm_to_ndir(torch.stack([x, y], -1))


# ---------------------------------------------------------------------------
# Hashes from "Improved Alpha Testing Using Hashed Sampling" (reference
# StochasticDepthMapRT/Common.slangh:36-51).
# ---------------------------------------------------------------------------

def hash2(v):
    """v: [..., 2] float -> [0, 1) float."""
    x, y = v[..., 0], v[..., 1]
    return torch.remainder(1.0e4 * torch.sin(17.0 * x + 0.1 * y)
                           * (0.1 + torch.abs(torch.sin(13.0 * y + x))), 1.0)


def hash3(v):
    return hash2(torch.stack([hash2(v[..., :2]), v[..., 2]], -1))

