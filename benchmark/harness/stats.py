"""Arithmetic of the end-to-end and trace metrics, kept apart from any
device so that the CPU tests reach it."""
from __future__ import annotations

import math


def window_rate_ms(window_s: float, frames: int) -> float:
    """Mean time per frame: the window's wall time over every frame it
    completed."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return window_s * 1e3 / frames


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle gaps [(start, end)] in [lo, hi] between the union of the
    intervals, longest first."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def idle_share_pct(busy: float, window: float) -> float:
    return 100.0 * (1.0 - busy / window)


def mse(a, b) -> float:
    """Mean squared difference of two tensors of one shape, in float64."""
    if tuple(a.shape) != tuple(b.shape):
        return math.inf
    d = a.double() - b.double()
    return float((d * d).mean())
