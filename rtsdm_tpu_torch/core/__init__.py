"""Harness services the renderer reads: the clock and the settings."""
