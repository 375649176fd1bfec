"""Hierarchical profiler (counterpart of rtsdm_tpu/core/profiler.py;
reference Utils/Timing/Profiler.h:49, FALCOR_PROFILE scopes
Profiler.h:276-298).

Named scopes nest into a tree of host-clock totals that exports to JSON
like Profiler::Capture (Profiler.h:138-191). While the profiler is
enabled, each scope is also a torch.profiler record_function named
SPAN_PREFIX + its path ("rtsdm/renderFrame/SVAO/phase1"), so that under
torch.profiler the program's spans lie in one trace with the device's
activities, on one clock. PyTorch launches work on the GPU
asynchronously: a scope times the host's work only.

Renderer.renderFrame makes its profiler the active one for the frame
(Profiler.activate); profile_scope opens a scope on it from code that has
no RenderContext (ops/*). A disabled profiler, or none active, costs one
test a scope and allocates nothing.
"""
from __future__ import annotations

import json
import time

from torch.profiler import record_function

SPAN_PREFIX = "rtsdm/"


class _Null:
    """The scope of a disabled profiler: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SCOPE = _Null()

# the profiler Renderer.renderFrame made active for the frame (enabled
# ones only), which profile_scope opens its scopes on
_active = None


class _Event:
    __slots__ = ("name", "path", "count", "total", "children")

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.count = 0
        self.total = 0.0
        self.children: dict[str, _Event] = {}

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "count": self.count,
            "total_ms": self.total * 1e3,
            "avg_ms": (self.total / self.count * 1e3) if self.count else 0.0,
            "children": [c.to_dict() for c in self.children.values()],
        }


class _Scope:
    """One enabled scope: a node of the tree, timed on the host clock,
    and a record_function span of its path."""
    __slots__ = ("prof", "name", "args", "ev", "span", "t0")

    def __init__(self, prof, name: str, args):
        self.prof = prof
        self.name = name
        self.args = args

    def __enter__(self):
        parent = self.prof._stack[-1]
        ev = parent.children.get(self.name)
        if ev is None:
            path = f"{parent.path}/{self.name}" if parent.path else self.name
            ev = parent.children[self.name] = _Event(self.name, path)
        self.ev = ev
        self.prof._stack.append(ev)
        self.span = record_function(SPAN_PREFIX + ev.path, self.args)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, exc_type, exc, tb):
        self.ev.total += time.perf_counter() - self.t0
        self.ev.count += 1
        self.span.__exit__(exc_type, exc, tb)
        self.prof._stack.pop()
        return False


class _Activation:
    __slots__ = ("prof", "prev")

    def __init__(self, prof):
        self.prof = prof

    def __enter__(self):
        global _active
        self.prev, _active = _active, self.prof
        return None

    def __exit__(self, exc_type, exc, tb):
        global _active
        _active = self.prev
        return False


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.reset()

    def event(self, name: str, frame: int | None = None):
        """Time the enclosed block under `name`, nested in the open scope;
        `frame` (top-level scopes) rides on the span as its args."""
        if not self.enabled:
            return NULL_SCOPE
        return _Scope(self, name, None if frame is None else str(frame))

    def activate(self):
        """Make this profiler the one profile_scope opens scopes on, for
        the enclosed block (while enabled)."""
        if not self.enabled:
            return NULL_SCOPE
        return _Activation(self)

    def reset(self):
        self.root = _Event("/", "")
        self._stack = [self.root]

    def capture(self) -> dict:
        return self.root.to_dict()

    def capture_json(self) -> str:
        return json.dumps(self.capture(), indent=2)

    def flat_averages(self) -> dict[str, float]:
        """'parent/child' scope path -> average ms (the PathBenchmark CSV
        source, reference PathBenchmark.cpp:59-90)."""
        out = {}

        def walk(ev):
            for c in ev.children.values():
                out[c.path] = (c.total / c.count * 1e3) if c.count else 0.0
                walk(c)

        walk(self.root)
        return out


def profile_scope(name: str):
    """A scope named `name` on the active profiler, nested in its open
    scope; without one, a scope that does nothing."""
    prof = _active
    if prof is None:
        return NULL_SCOPE
    return prof.event(name)
