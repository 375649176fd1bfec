"""Render passes of the port; importing the package registers them."""
from . import (blur, depth_chain, gbuffer, hbao,  # noqa: F401
               image_equation, interleave, lighting, stochastic_depth, svao,
               temporal, tonemap)
