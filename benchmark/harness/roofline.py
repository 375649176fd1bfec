"""The yardstick of the rooflines: the card's published peaks and what the
work of a kernel's call needs, counted from the cell's inputs and the
reference's results, never from the program's own chunks, lists or culls.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores (the port's kernels use none: their
results must match float32 arithmetic bit for bit) and 3.35 TB/s of HBM.

Raster (K1): each (pixel sample, triangle) coverage the frame needs, that
is each fragment that passes the visibility test, costs 24 operations:
five edge functions of four each, the depth division and three for the
test's tolerance. It reads each triangle's positions once (36 bytes) and
writes each pixel's depth, id and two barycentrics once (16 bytes).

Any-hit (K8): each pair of a live ray and a triangle whose axis-aligned
box the ray's segment meets costs 41 operations, the arithmetic of the
Moller-Trumbore test. It reads each triangle's positions and alpha mask
once (40 bytes), each live ray's origin, direction and interval once (32
bytes) and writes its answer once (1 byte)."""
from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

RASTER_OPS_PER_COVERAGE = 24
RASTER_BYTES_PER_TRIANGLE = 36
RASTER_BYTES_PER_PIXEL = 16
ANY_HIT_OPS_PER_PAIR = 41
ANY_HIT_BYTES_PER_TRIANGLE = 40
ANY_HIT_BYTES_PER_RAY = 33


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the operations
    over the float32 peak and the bytes over the memory's."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def raster_bound_s(calls) -> float:
    """Summed bound of the raster calls the reference recorded."""
    return sum(bound_s(c["coverages"] * RASTER_OPS_PER_COVERAGE,
                       c["triangles"] * RASTER_BYTES_PER_TRIANGLE
                       + c["pixels"] * RASTER_BYTES_PER_PIXEL)
               for c in calls)


def any_hit_bound_s(calls) -> float:
    """Summed bound of the any-hit calls the reference recorded."""
    return sum(bound_s(c["pairs"] * ANY_HIT_OPS_PER_PAIR,
                       c["triangles"] * ANY_HIT_BYTES_PER_TRIANGLE
                       + c["rays"] * ANY_HIT_BYTES_PER_RAY)
               for c in calls)
