"""Harness services the renderer reads: the clock, the settings and the
profiler."""
