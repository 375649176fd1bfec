"""Render passes of the port; importing the package registers them."""
from . import (ao_extra, blur, depth_chain, gbuffer, hbao,  # noqa: F401
               image_equation, interleave, lighting, measure, pipeline_misc,
               stochastic_depth, stubs, svao, temporal, tonemap)
