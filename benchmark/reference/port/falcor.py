"""`from falcor import *` surface for graph scripts run by the port's harness
(counterpart of rtsdm_tpu/falcor.py; reference FalcorPython.cpp:52).

The reference package installs itself as the `falcor` module for good when
it is imported. This one does not: mogwai.run_script puts it in
sys.modules["falcor"] only while a script runs (installed()), and hides a
cached scripts/_graphlib.py for that time, so a process that also runs the
reference package's scripts builds each package's own RenderGraph.
"""
from __future__ import annotations

import contextlib
import sys

from . import passes  # noqa: F401  (registers the pass types)
from .rendergraph.graph import RenderGraph  # noqa: F401
from .rendergraph.render_pass import PASS_REGISTRY, create_pass  # noqa: F401

# Falcor's vector types and enums; the passes take plain values and strings
uint2 = tuple
uint3 = tuple
float2 = tuple
float3 = tuple
float4 = tuple


class ResourceFormat:
    def __getattr__(self, name):
        return name


def createPass(pass_type: str, props: dict | None = None):
    """Upstream binding name of the pass factory."""
    return create_pass(pass_type, props)


__all__ = ["RenderGraph", "create_pass", "createPass", "uint2", "uint3",
           "float2", "float3", "float4", "ResourceFormat"]

# modules a graph script binds to whichever `falcor` it imported first
_SCRIPT_MODULES = ("falcor", "_graphlib")
_ABSENT = object()


@contextlib.contextmanager
def installed():
    """`import falcor` resolves to this module inside the block, and
    `_graphlib` is imported afresh; both entries of sys.modules are put back
    as they were afterwards."""
    saved = {k: sys.modules.get(k, _ABSENT) for k in _SCRIPT_MODULES}
    sys.modules["falcor"] = sys.modules[__name__]
    sys.modules.pop("_graphlib", None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is _ABSENT:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
