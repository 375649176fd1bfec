"""Render passes of the port; importing the package registers them."""
from . import (blur, depth_chain, gbuffer, image_equation,  # noqa: F401
               lighting, stochastic_depth, svao, temporal, tonemap)
