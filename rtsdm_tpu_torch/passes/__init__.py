"""Render passes of the SVAO slice; importing the package registers them."""
from . import depth_chain, gbuffer, stochastic_depth, svao  # noqa: F401
