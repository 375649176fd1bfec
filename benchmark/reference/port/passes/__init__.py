"""Render passes of the port; importing the package registers them."""
from . import (ao_extra, blur, depth_chain, gbuffer,  # noqa: F401
               image_equation, lighting, pipeline_misc,
               stochastic_depth, svao, temporal, tonemap)
