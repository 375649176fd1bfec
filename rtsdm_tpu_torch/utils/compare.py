"""Image comparison metrics (counterpart of rtsdm_tpu/utils/compare.py;
reference Source/Tools/ImageCompare/ImageCompare.cpp:257-260): MSE, RMSE,
MAE, MAPE, the published LDR-FLIP error map and, for the quality oracle,
SSIM. The Gaussian blur and FLIP's filters are convolutions through
torch.nn.functional.conv2d over edge-replicated images (TF32 stays off,
rtsdm_tpu_torch/__init__.py)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .math import true_div


def mse(a, b):
    return torch.mean((a - b) ** 2)


def rmse(a, b):
    return torch.sqrt(mse(a, b))


def mae(a, b):
    return torch.mean(torch.abs(a - b))


def mape(a, b, eps=1e-2):
    return torch.mean(torch.abs(a - b) / (torch.abs(b) + eps))


def _gauss_kernel(radius: int = 5, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv2d_same(img, kernel):
    """[H, W] (x) [kh, kw] (numpy) with edge-clamped reads (the shader
    clamps neighbourhood reads to the image, FLIPPass.cs.slang:172-176)."""
    kh, kw = kernel.shape
    p = F.pad(img[None, None], (kw // 2, kw // 2, kh // 2, kh // 2),
              mode="replicate")
    k = torch.as_tensor(np.ascontiguousarray(kernel, np.float32),
                        device=img.device)
    return F.conv2d(p, k[None, None])[0, 0]


def _blur(x, radius: int = 5, sigma: float = 1.5):
    """Separable Gaussian blur of [H, W] with edge-clamped reads."""
    k = _gauss_kernel(radius, sigma)
    x = _conv2d_same(x, k[:, None])
    return _conv2d_same(x, k[None, :])


def ssim(a, b, c1=0.01 ** 2, c2=0.03 ** 2):
    """Mean SSIM of [H, W] or [H, W, C] images in [0, 1] (11x11 Gaussian
    window, sigma 1.5; colour images by their mean of the first three
    channels)."""
    a = a if a.ndim == 2 else a[..., :3].mean(-1)
    b = b if b.ndim == 2 else b[..., :3].mean(-1)
    mu_a = _blur(a)
    mu_b = _blur(b)
    var_a = _blur(a * a) - mu_a * mu_a
    var_b = _blur(b * b) - mu_b * mu_b
    cov = _blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


# ---------------------------------------------------------------------------
# FLIP (the published LDR metric: Andersson et al., HPG 2020), as the
# reference's FLIPPass.cs.slang:96-247 computes it: CSF filters per opponent
# channel, Gaussian first- and second-derivative feature detectors, and the
# error redistribution.
# ---------------------------------------------------------------------------

_QC, _PC, _PT, _W, _QF = 0.7, 0.4, 0.95, 0.082, 0.5  # FLIPPass.cs.slang:60-64

# Rec.709 <-> XYZ (D65)
_RGB2XYZ = np.array([[0.4124, 0.3576, 0.1805],
                     [0.2126, 0.7152, 0.0722],
                     [0.0193, 0.1192, 0.9505]], np.float64)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_D65 = np.array([0.950428545, 1.0, 1.088900371], np.float64)


def _mat3(m, c):
    """[..., 3] through the 3x3 numpy matrix m (float32)."""
    m = m.astype(np.float32)
    return torch.stack([c[..., 0] * float(m[i, 0]) + c[..., 1] * float(m[i, 1])
                        + c[..., 2] * float(m[i, 2]) for i in range(3)], -1)


def _d65(device):
    return torch.as_tensor(_D65.astype(np.float32), device=device)


def _rgb_to_ycxcz(c):
    xyz = _mat3(_RGB2XYZ, c) / _d65(c.device)
    y = 116.0 * xyz[..., 1] - 16.0
    cx = 500.0 * (xyz[..., 0] - xyz[..., 1])
    cz = 200.0 * (xyz[..., 1] - xyz[..., 2])
    return torch.stack([y, cx, cz], -1)


def _ycxcz_to_rgb(c):
    y = true_div(c[..., 0] + 16.0, 116.0)
    x = y + true_div(c[..., 1], 500.0)
    z = y - true_div(c[..., 2], 200.0)
    xyz = torch.stack([x, y, z], -1) * _d65(c.device)
    return _mat3(_XYZ2RGB, xyz)


def _rgb_to_cielab(c):
    t = _mat3(_RGB2XYZ, c) / _d65(c.device)
    d = 6.0 / 29.0
    f = torch.where(t > d ** 3, torch.pow(torch.clamp(t, min=1e-12),
                                          1.0 / 3.0),
                    true_div(t, 3.0 * d * d) + 4.0 / 29.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], -1)


def _hunt(lab):
    h = 0.01 * lab[..., 0:1]
    return torch.cat([lab[..., 0:1], h * lab[..., 1:]], -1)


def _hyab(a, b):
    d = a - b
    return torch.abs(d[..., 0]) + torch.sqrt(d[..., 1] ** 2 + d[..., 2] ** 2
                                             + 1e-20)


def _flip_kernels(ppd: float):
    """Filter kernels (numpy float32) for a pixels-per-degree value: the
    three CSF filters, the point (second-derivative) and edge
    (first-derivative) detectors along x and y."""
    radius = int(np.ceil(3.0 * np.sqrt(0.04 / (2.0 * np.pi ** 2)) * ppd))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")

    def csf(ab):
        a1, a2, b1, b2 = ab
        d2 = -((gx / ppd) ** 2 + (gy / ppd) ** 2) * np.pi ** 2
        w = (a1 * np.sqrt(np.pi / b1) * np.exp(d2 / b1)
             + a2 * np.sqrt(np.pi / b2) * np.exp(d2 / b2))
        return w / w.sum()

    k_a = csf((1.0, 0.0, 0.0047, 1e-5))
    k_rg = csf((1.0, 0.0, 0.0053, 1e-5))
    k_by = csf((34.1, 13.5, 0.04, 0.025))
    # feature detectors (FLIPPass.cs.slang:156-231)
    sig = 0.5 * _W * ppd
    g = np.exp(-(gx ** 2 + gy ** 2) / (2.0 * sig * sig))
    point_x = (gx ** 2 / (sig * sig) - 1.0) * g
    point_y = (gy ** 2 / (sig * sig) - 1.0) * g
    pos_sum = point_x[point_x >= 0].sum()
    neg_sum = -point_x[point_x < 0].sum()
    point_x = np.where(point_x >= 0, point_x / pos_sum, point_x / neg_sum)
    point_y = np.where(point_y >= 0, point_y / pos_sum, point_y / neg_sum)
    edge_x = -gx * g
    edge_y = -gy * g
    e_sum = edge_x[edge_x >= 0].sum()
    edge_x, edge_y = edge_x / e_sum, edge_y / e_sum
    return [k.astype(np.float32)
            for k in (k_a, k_rg, k_by, point_x, point_y, edge_x, edge_y)]


def flip_error(a, b, monitor_width_pixels=3840, monitor_width_meters=0.7,
               monitor_distance=0.7):
    """Per-pixel LDR-FLIP error map [H, W] of test `a` against reference
    `b` (FLIPPass.cs.slang LDRFLIP). Inputs: linear RGB [H, W, 3] (or
    [H, W], taken as gray) in [0, 1]."""
    a3 = a if a.ndim == 3 else a[..., None].expand(a.shape + (3,))
    b3 = b if b.ndim == 3 else b[..., None].expand(b.shape + (3,))
    a3 = torch.clamp(a3[..., :3], 0.0, 1.0)
    b3 = torch.clamp(b3[..., :3], 0.0, 1.0)
    ppd = monitor_distance * (monitor_width_pixels / monitor_width_meters) \
        * (np.pi / 180.0)
    k_a, k_rg, k_by, p_x, p_y, e_x, e_y = _flip_kernels(ppd)
    ref_y = _rgb_to_ycxcz(b3)
    tst_y = _rgb_to_ycxcz(a3)

    # colour pipeline: a CSF filter per opponent channel
    def csf_filter(img):
        return torch.stack([_conv2d_same(img[..., 0], k_a),
                            _conv2d_same(img[..., 1], k_rg),
                            _conv2d_same(img[..., 2], k_by)], -1)

    ref_f = torch.clamp(_ycxcz_to_rgb(csf_filter(ref_y)), 0.0, 1.0)
    tst_f = torch.clamp(_ycxcz_to_rgb(csf_filter(tst_y)), 0.0, 1.0)
    color_diff = _hyab(_hunt(_rgb_to_cielab(ref_f)),
                       _hunt(_rgb_to_cielab(tst_f)))

    # feature pipeline on normalized luminance
    def grads(img_y):
        lum = true_div(img_y + 16.0, 116.0)
        pg = torch.sqrt(_conv2d_same(lum, p_x) ** 2
                        + _conv2d_same(lum, p_y) ** 2 + 1e-20)
        eg = torch.sqrt(_conv2d_same(lum, e_x) ** 2
                        + _conv2d_same(lum, e_y) ** 2 + 1e-20)
        return pg, eg

    ref_pg, ref_eg = grads(ref_y[..., 0])
    tst_pg, tst_eg = grads(tst_y[..., 0])
    feature_diff = torch.maximum(torch.abs(ref_pg - tst_pg),
                                 torch.abs(ref_eg - tst_eg)) * (0.5 ** 0.5)
    feature_diff = feature_diff ** _QF

    # error redistribution (FLIPPass.cs.slang:115-133)
    dev = a3.device
    green = _hunt(_rgb_to_cielab(torch.tensor([[0.0, 1.0, 0.0]],
                                              device=dev)))
    blue = _hunt(_rgb_to_cielab(torch.tensor([[0.0, 0.0, 1.0]],
                                             device=dev)))
    max_dist = _hyab(green, blue)[0] ** _QC
    err = color_diff ** _QC
    cutoff = _PC * max_dist
    err = torch.where(err < cutoff, err * (_PT / cutoff),
                      _PT + (err - cutoff) / (max_dist - cutoff)
                      * (1.0 - _PT))
    return torch.clamp(err, 0.0, 1.0) ** (1.0 - feature_diff)


def compare(a, b, metric: str = "mse") -> float:
    """One metric of image `a` against reference `b` (arrays or tensors)."""
    fns = {"mse": mse, "rmse": rmse, "mae": mae, "mape": mape, "ssim": ssim,
           "flip": lambda x, y: torch.mean(flip_error(x, y))}

    def tensor(x):
        return x.to(torch.float32) if torch.is_tensor(x) \
            else torch.as_tensor(np.asarray(x, np.float32))

    return float(fns[metric](tensor(a), tensor(b)))
