"""The render-pass contract (counterpart of rtsdm_tpu/rendergraph/
render_pass.py; reference RenderPass.h:151-235 and the plugin registry).

A pass declares its config keys with defaults in SCHEMA (unknown keys warn,
like the reference's "Unknown field" log), its channels in reflect(), and
maps (ctx, inputs, state) -> (outputs, new_state) in execute().
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any

from ..core.profiler import NULL_SCOPE

log = logging.getLogger("rtsdm_tpu_torch")

PASS_REGISTRY: dict[str, type] = {}


def register_pass(name: str):
    """FALCOR_PLUGIN_CLASS + registerPlugin equivalent."""
    def deco(cls):
        cls.pass_type = name
        PASS_REGISTRY[name] = cls
        return cls
    return deco


def create_pass(pass_type: str, props: dict | None = None):
    """RenderGraph::createPass plugin lookup."""
    if pass_type not in PASS_REGISTRY:
        raise KeyError(f"unknown render pass type '{pass_type}' "
                       f"(registered: {sorted(PASS_REGISTRY)})")
    return PASS_REGISTRY[pass_type](props or {})


@dataclasses.dataclass
class ChannelDesc:
    name: str
    desc: str = ""
    optional: bool = False


@dataclasses.dataclass
class PassReflection:
    """reflect() result (RenderPassReflection field DSL)."""
    inputs: list[ChannelDesc] = dataclasses.field(default_factory=list)
    outputs: list[ChannelDesc] = dataclasses.field(default_factory=list)

    def add_input(self, name, desc="", optional=False):
        self.inputs.append(ChannelDesc(name, desc, optional))
        return self

    def add_output(self, name, desc="", optional=False):
        self.outputs.append(ChannelDesc(name, desc, optional))
        return self


@dataclasses.dataclass
class RenderContext:
    """Per-frame execution context. width/height: full render resolution
    (including any guard band); dictionary: the inter-pass scalar dictionary
    (e.g. guardBand)."""
    width: int
    height: int
    scene: Any = None
    frame_index: int = 0
    time: float = 0.0
    dictionary: dict = dataclasses.field(default_factory=dict)
    # core.profiler.Profiler timing each pass (graph.execute), or None
    profiler: Any = None
    # output channels of the running pass that something consumes; set by
    # RenderGraph.execute, None when a pass runs on its own
    consumed_outputs: Any = None
    # PixelDebug (reference PixelDebug.h:65, a shader print() gated to one
    # pixel): with pixel_debug = (x, y) set, passes' debug_print calls
    # append (name, value at that pixel) to debug_log; None costs nothing
    pixel_debug: Any = None
    debug_log: list = dataclasses.field(default_factory=list)

    @property
    def guard_band(self) -> int:
        return int(self.dictionary.get("guardBand", 0))

    def span(self, name: str):
        """A scope named `name` on the context's profiler, nested in its
        open scope; without a profiler, a scope that does nothing."""
        if self.profiler is None:
            return NULL_SCOPE
        return self.profiler.event(name)

    def debug_print(self, name: str, arr) -> None:
        """Record arr[y, x(, ...)] at the selected debug pixel, clamped to
        the array (a no-op, with no device sync, while no pixel is
        selected or arr has fewer than two dimensions)."""
        if self.pixel_debug is None or not hasattr(arr, "ndim") \
                or arr.ndim < 2:
            return
        x, y = self.pixel_debug
        y = min(max(int(y), 0), arr.shape[0] - 1)
        x = min(max(int(x), 0), arr.shape[1] - 1)
        self.debug_log.append((name, arr[y, x]))


class RenderPass:
    """Base class: subclasses override reflect() / execute()."""

    pass_type = "RenderPass"
    SCHEMA: dict[str, Any] = {}

    def __init__(self, props: dict | None = None):
        self.cfg = dict(self.SCHEMA)
        for k, v in (props or {}).items():
            if k in self.SCHEMA:
                self.cfg[k] = v
            else:
                log.warning("Unknown field '%s' in a %s dictionary", k,
                            self.pass_type)
        self.scene = None
        self.name = self.pass_type

    def reflect(self, ctx: RenderContext) -> PassReflection:
        return PassReflection()

    def unused_inputs(self, ctx: RenderContext):
        """Declared inputs this pass ignores under its current config; the
        graph drops their edges and prunes producers that feed nothing."""
        return ()

    def set_scene(self, scene):
        self.scene = scene

    def init_state(self, ctx: RenderContext):
        """Initial temporal state (None for stateless passes)."""
        return None

    def execute(self, ctx: RenderContext, inputs: dict, state=None):
        """Returns (outputs: dict, new_state)."""
        raise NotImplementedError

    def __repr__(self):
        return f"<{self.pass_type} '{self.name}'>"
