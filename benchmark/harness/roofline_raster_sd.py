"""The yardstick of the stochastic-depth raster (K9, csrc/raster_sd.cu):
what the work of its calls needs, counted from the reference's results
(reference/port/ops/ref_raster_sd.py, its own cull), never from the
program's chunks, lists or culls, against harness/roofline.py's peaks.

Operations. Each (SD texel, triangle) coverage, a fragment that passes
K9's coverage test (three edge values at or above 0, w > 0, 0 <= z <= 1),
costs 24 float32 operations: four planes of four (the three edge
functions and w), the z plane and its division (five), and the view depth
wd / (e0 + e1 + e2) (two adds and a division, three). Each coverage that
is also inserted (behind the first layer and inside the ray interval)
costs 4 more: the two draws' scalings by 1 / 32767 and the coverage
mask's alpha * k + rng and its group product. The hash is integer work,
which the float32 peak does not count.

Bytes. Each triangle's positions are read once (36 bytes); each SD texel's
first depth and ray interval are read once (12 bytes) and its k slots
written once (4 * k bytes)."""
from __future__ import annotations

from . import roofline

OPS_PER_COVERAGE = 24
OPS_PER_INSERTED = 4
BYTES_PER_TRIANGLE = 36
BYTES_READ_PER_TEXEL = 12
BYTES_PER_SLOT = 4


def raster_sd_calls(calls) -> list:
    """The K9 entries among the raster calls the reference recorded."""
    return [c for c in calls or () if "sd_coverages" in c]


def raster_sd_bound_s(calls) -> float:
    """Summed bound of the K9 calls among the reference's raster calls."""
    return sum(roofline.bound_s(
        c["sd_coverages"] * OPS_PER_COVERAGE
        + c["sd_inserted"] * OPS_PER_INSERTED,
        c["sd_triangles"] * BYTES_PER_TRIANGLE
        + c["sd_texels"] * (BYTES_READ_PER_TEXEL + BYTES_PER_SLOT * c["k"]))
        for c in raster_sd_calls(calls))
