"""Deliberate stubs for vendor integrations (counterpart of
rtsdm_tpu/passes/stubs.py): each passes its first input through unchanged
and logs once. Ported so far: DLSSPass."""
from __future__ import annotations

from ..rendergraph.render_pass import (PassReflection, RenderPass, log,
                                       register_pass)


@register_pass("DLSSPass")
class DLSSPass(RenderPass):
    """Pass-through for the DLSS upscaler: 'output' is 'color'."""

    SCHEMA = dict(enabled=True, outputSize="Default", profile="Balanced",
                  motionVectorScale="Relative", isHDR=True, sharpness=0.0,
                  exposure=0.0)
    _warned = False

    def reflect(self, ctx):
        return (PassReflection().add_input("color")
                .add_input("mvec", optional=True)
                .add_input("depth", optional=True).add_output("output"))

    def execute(self, ctx, inputs, state=None):
        if not DLSSPass._warned:
            log.warning("DLSSPass is a deliberate pass-through stub (vendor "
                        "integration without a port)")
            DLSSPass._warned = True
        return {"output": inputs["color"]}, None
