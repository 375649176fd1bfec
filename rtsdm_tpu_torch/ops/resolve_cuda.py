"""SVAO phase 2's per-direction resolve: the wrapper of
csrc/svao_resolve.cu (K12) and the ring's float32 constants it takes from
the host. K12 replaces no TPU kernel: the JAX package resolves phase 2
with XLA code (rtsdm_tpu/passes/svao_shift.py, svao_phase2_shift's
direction loop). Its plain version is that loop,
passes/svao_shift.svao_resolve_plain, which a CPU tensor takes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .._build import kernel_library, launch, ptr, stream_of
from ..core.profiler import profile_scope
from ..utils.sampling import AO_KERNEL_VAO, JITTER_4X4
from . import ao as A
from . import ao_shift as S

MAX_BOUNDS = 63        # csrc/svao_resolve.cu: the level bounds and the
MAX_LAUNCH_DIRS = 16   # directions of a launch its arguments hold
DIR_CONSTS = 36        # per direction: sin, cos, radius fraction, HBAO pdf,
                       # the 16 classes' screen x, then y

# the setup planes of passes/svao_shift._deint_b K12 reads, by
# ResolveArgs field: (field, key, component)
PLANES = (("radius_px", "radius_px", None), ("radius", "radius", None),
          ("pos_len", "pos_len", None), ("ax", "a", 0), ("ay", "a", 1),
          ("az", "a", 2), ("nox", "no", 0), ("noy", "no", 1),
          ("noz", "no", 2))
HBAO_PLANES = (("px", "px", None), ("py", "py", None), ("pz", "pz", None),
               ("nx", "n", 0), ("ny", "n", 1), ("nz", "n", 2))


class ResolveArgs(ctypes.Structure):
    """csrc/svao_resolve.cu's ResolveArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name, _, _ in PLANES]
                + [(name, ctypes.c_void_p) for name, _, _ in HBAO_PLANES]
                + [(name, ctypes.c_void_p) for name in (
                    "fetched", "sd", "stencil", "delta_in", "delta_out", "sx",
                    "sy", "depth_range", "near_z")]
                + [(name, ctypes.c_int) for name in (
                    "d0", "d1", "k", "sd_dir_stride", "sd_class_stride",
                    "n_levels", "qh", "qw", "w", "h", "low_w", "low_h")]
                + [(name, ctypes.c_float) for name in (
                    "thick1", "radius2", "inv_divisor")]
                + [("jitter", ctypes.c_float * 32),
                   ("bounds", ctypes.c_float * MAX_BOUNDS),
                   ("level_radius", ctypes.c_float * (MAX_BOUNDS + 1)),
                   ("dir_consts",
                    ctypes.c_float * (MAX_LAUNCH_DIRS * DIR_CONSTS))])


def direction_constants(radii) -> np.ndarray:
    """[nd, DIR_CONSTS] float32: per ring direction i, the numbers the
    plain loop hands PyTorch, each rounded to float32 as PyTorch rounds a
    Python number: sin and cos of alpha = i / nd * 2 * 3.141 (the loop's
    dxy), radii[i] (its level lookup), HBAO's pdf 0.9 * (1 - radii[i]) **
    1.5, and the 16 classes' screen direction (_class_consts: x, then
    y)."""
    nd = len(radii)
    thetas = S.class_angles()
    out = np.zeros((nd, DIR_CONSTS), np.float32)
    for i in range(nd):
        alpha = (i / nd) * 2.0 * 3.141
        r = float(radii[i])
        u = np.asarray([S.screen_dir(alpha, float(t)) for t in thetas],
                       np.float32)
        out[i, :4] = (math.sin(alpha), math.cos(alpha), r,
                      0.9 * (1.0 - r) ** 1.5)
        out[i, 4:20], out[i, 20:] = u[:, 0], u[:, 1]
    return out


def ring_constants(levels, radii):
    """(level bounds, level radii, direction constants) float32 of a ring,
    on the host: the bounds shift_level_index compares with, the radii
    level_radius reads (the host's exp), direction_constants."""
    bounds = A.level_bounds(np.asarray(levels, np.float32))
    if len(bounds) > MAX_BOUNDS or bool((np.diff(bounds) < 0).any()):
        raise ValueError("svao_resolve: at most 63 ascending level bounds")
    level_r = S._level_radius_table(tuple(float(v) for v in levels),
                                    torch.device("cpu")).numpy()
    return bounds, level_r, direction_constants(radii)


def config_constants(cfg, divisor: int) -> tuple:
    """float32 (1 + thickness, radius^2, 1 / divisor): the halo's
    (1.0 + cfg.thickness) and HBAO's cfg.radius * cfg.radius, Python
    numbers PyTorch rounds to float32, and the reciprocal PyTorch's CUDA
    division by float(divisor) multiplies by."""
    return tuple(np.asarray([1.0 + cfg.thickness, cfg.radius * cfg.radius,
                             np.float32(1.0) / np.float32(divisor)],
                            np.float32).tolist())


def check_layout() -> None:
    """Raise unless ResolveArgs has the size and field offsets of the
    kernel's struct (csrc/svao_resolve.cu rtsdm_svao_resolve_layout)."""
    fields = [name for name, _ in ResolveArgs._fields_]
    out = (ctypes.c_longlong * (len(fields) + 1))()
    n = kernel_library()["rtsdm_svao_resolve_layout"](out, len(out))
    want = [ctypes.sizeof(ResolveArgs)] + [getattr(ResolveArgs, f).offset
                                           for f in fields]
    if n != len(fields) or list(out) != want:
        raise RuntimeError(f"svao_resolve: ResolveArgs differs from the "
                           f"kernel's struct (size and offsets {list(out)}"
                           f" of {n} fields, here {want})")


@functools.lru_cache(maxsize=64)
def _launch_constants(cfg, levels: bytes, radii: tuple, sd_jitter: bool,
                      divisor: int, lo: int, hi: int) -> ResolveArgs:
    """ResolveArgs holding what a launch of directions lo..hi - 1 takes
    from cfg and the ring (levels: the float32 level table's bytes), made
    once, its layout checked against the kernel's; every launch copies it
    and sets the tensors and shapes."""
    check_layout()
    levels = np.frombuffer(levels, np.float32)
    bounds, level_r, dirs = ring_constants(levels, radii)
    args = ResolveArgs()
    for field, values in (("jitter", JITTER_4X4 if sd_jitter
                           else np.full(32, 0.5)), ("bounds", bounds),
                          ("level_radius", level_r),
                          ("dir_consts", dirs[lo:hi])):
        values = np.ascontiguousarray(values, np.float32)
        ctypes.memmove(getattr(args, field), values.ctypes.data,
                       values.nbytes)
    args.d0, args.d1, args.n_levels = lo, hi, len(levels)
    args.w, args.h = cfg.resolution
    args.low_w, args.low_h = cfg.low_resolution
    args.thick1, args.radius2, args.inv_divisor = config_constants(cfg,
                                                                   divisor)
    return args


def _plane(t, shape, what):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
            or tuple(t.shape) != shape:
        raise ValueError(f"svao_resolve: {what} must be a float32 tensor "
                         f"of shape {shape}")
    return t.contiguous()


def svao_resolve(cfg, bq, levels, radii, fetched, sd, stencil_q, depth_range,
                 near_z, k: int, divisor: int, sd_jitter: bool, delta_q=None,
                 d=None):
    """K12: calcAO2's correction (Common.slang:523-663) of ring direction d,
    or of every direction when d is None, added in direction order to
    delta_q (0 when None); returns a new [16, qh, qw] float32 tensor and
    leaves delta_q as it was. bq: the deinterleaved setup planes
    (passes/svao_shift._deint_b); levels and radii: the ring's
    (svao_shift._ring); fetched: K3's [nd, 16, qh, qw] depth planes; sd:
    K4's 16-bit pairs [nd, 16, ceil(k/2), qh, qw] int32 of every direction
    (d None), or K11's [16, k, qh, qw] float32 of direction d; stencil_q
    [16, qh, qw] int32; depth_range and near_z 0-d tensors. One launch for
    up to 16 directions. Equal bit for bit to
    passes/svao_shift.svao_resolve_plain on the card."""
    with profile_scope("kernel.svao_resolve"):
        if not stencil_q.is_cuda:
            if stencil_q.device.type != "cpu":
                raise RuntimeError(f"svao_resolve: unsupported device "
                                   f"{stencil_q.device}")
            from ..passes import svao_shift
            return svao_shift.svao_resolve_plain(
                cfg, bq, levels, radii, fetched, sd, stencil_q, depth_range,
                near_z, k, divisor, sd_jitter, delta_q, d)
        dev = stencil_q.device
        nd = len(radii)
        if stencil_q.dtype != torch.int32 or stencil_q.ndim != 3 \
                or stencil_q.shape[0] != 16:
            raise ValueError("svao_resolve: stencil [16, qh, qw] int32")
        qh, qw = stencil_q.shape[1:]
        shape = (16, qh, qw)
        d0, d1 = (0, nd) if d is None else (int(d), int(d) + 1)
        if not 0 <= d0 < d1 <= nd or not 1 <= k <= 8:
            raise ValueError("svao_resolve: a direction of the ring and 1 "
                             "to 8 SD samples")
        packed = sd.dtype == torch.int32
        slots = (k + 1) // 2 if packed else k
        sd_shape = (16, slots, qh, qw) if d is not None \
            else (nd, 16, slots, qh, qw)
        if sd.dtype not in (torch.int32, torch.float32) \
                or tuple(sd.shape) != sd_shape or sd.device != dev:
            raise ValueError(f"svao_resolve: SD values {sd_shape}, int32 "
                             "pairs or float32")
        vao = cfg.kernel == AO_KERNEL_VAO
        keep = {"stencil": stencil_q.contiguous(), "sd": sd.contiguous(),
                "fetched": _plane(fetched, (nd,) + shape, "fetched")}
        for name, key, comp in PLANES + (() if vao else HBAO_PLANES):
            keep[name] = _plane(bq[key] if comp is None else bq[key][comp],
                                shape, f"bq[{key!r}]")
        for name, v in (("sx", bq["sx"]), ("sy", bq["sy"]),
                        ("depth_range", depth_range), ("near_z", near_z)):
            keep[name] = _plane(v, (), name)
        if delta_q is not None:
            keep["delta_in"] = _plane(delta_q, shape, "delta_q")
        if any(t.device != dev for t in keep.values()):
            raise ValueError("svao_resolve: every tensor on one device")
        if 16 * nd * qh * qw >= 2**31 or sd.numel() >= 2**31:
            raise ValueError("svao_resolve: more than 2^31 values")
        levels_key = np.asarray(levels, np.float32).tobytes()
        radii_key = tuple(float(r) for r in radii)
        dir_stride = 16 * slots * qh * qw if d is None else 0
        out = None
        for lo in range(d0, d1, MAX_LAUNCH_DIRS):
            hi = min(lo + MAX_LAUNCH_DIRS, d1)
            args = ResolveArgs.from_buffer_copy(_launch_constants(
                cfg, levels_key, radii_key, bool(sd_jitter), int(divisor),
                lo, hi))
            for name, t in keep.items():
                setattr(args, name, ptr(t))
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            args.sd += (lo - d0) * dir_stride * sd.element_size()
            args.delta_out = ptr(out)
            (args.k, args.sd_dir_stride, args.sd_class_stride, args.qh,
             args.qw) = (k, dir_stride, slots * qh * qw, qh, qw)
            launch("rtsdm_svao_resolve", ctypes.addressof(args), int(vao),
                   int(packed), stream_of(out))
            keep["delta_in"] = out   # a longer ring's next launch adds on
        return out
