"""Hierarchical profiler (counterpart of rtsdm_tpu/core/profiler.py;
reference Utils/Timing/Profiler.h:49, FALCOR_PROFILE scopes
Profiler.h:276-298).

Named scopes nest into a tree of host-clock totals that exports to JSON
like Profiler::Capture (Profiler.h:138-191). PyTorch launches work on the
GPU asynchronously, so a scope given `outputs` synchronizes their CUDA
devices before it stops its clock when `sync` is set (the GpuTimer
equivalent); a scope without outputs times the host's work only.
"""
from __future__ import annotations

import contextlib
import json
import time

import torch


class _Event:
    __slots__ = ("name", "count", "total", "children")

    def __init__(self, name: str):
        self.name = name
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


def _synchronize(outputs) -> None:
    """Wait for the CUDA devices of the tensors in `outputs` (a tensor, or
    a dict / list / tuple nesting them)."""
    devices = set()
    stack = [outputs]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class Profiler:
    def __init__(self, enabled: bool = True, sync: bool = True):
        self.enabled = enabled
        self.sync = sync
        self.root = _Event("/")
        self._stack = [self.root]

    @contextlib.contextmanager
    def event(self, name: str, outputs=None):
        """Time the enclosed block under `name`, nested in the open scope."""
        if not self.enabled:
            yield
            return
        parent = self._stack[-1]
        ev = parent.children.get(name)
        if ev is None:
            ev = parent.children[name] = _Event(name)
        self._stack.append(ev)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and outputs is not None:
                _synchronize(outputs)
            ev.total += time.perf_counter() - t0
            ev.count += 1
            self._stack.pop()

    def reset(self):
        self.root = _Event("/")
        self._stack = [self.root]

    def capture(self) -> dict:
        return self.root.to_dict()

    def capture_json(self) -> str:
        return json.dumps(self.capture(), indent=2)

    def flat_averages(self) -> dict[str, float]:
        """'parent/child' scope path -> average ms (the PathBenchmark CSV
        source, reference PathBenchmark.cpp:59-90)."""
        out = {}

        def walk(ev, prefix):
            for c in ev.children.values():
                key = f"{prefix}/{c.name}" if prefix else c.name
                out[key] = (c.total / c.count * 1e3) if c.count else 0.0
                walk(c, key)

        walk(self.root, "")
        return out


_GLOBAL = Profiler(enabled=False)


def global_profiler() -> Profiler:
    return _GLOBAL


def profile_scope(name: str, outputs=None):
    return _GLOBAL.event(name, outputs)
