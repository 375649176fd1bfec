"""Render graph: a DAG of passes run in topological order (counterpart of
rtsdm_tpu/rendergraph/graph.py; reference RenderGraph.h, the compiler's
topological sort and liveness, RenderGraphCompiler.cpp:121-157). PyTorch
runs eagerly, so executing the graph dispatches pass by pass; temporal
passes carry their history in a state dict that the caller threads from
frame to frame (init_state, then each execute returns the new state).

With `time_passes` set, execute brackets every pass with two CUDA events
on the current stream; pass_times_ms() reads them after a synchronize. A
context's profiler (core/profiler.py) times each pass on the host clock
under its name.
"""
from __future__ import annotations

from collections import defaultdict, deque

import torch

from .render_pass import RenderContext, RenderPass, create_pass


class RenderGraph:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.passes: dict[str, RenderPass] = {}
        self.edges: list[tuple[str, str, str, str]] = []  # sp, sc, dp, dc
        self.order_edges: list[tuple[str, str]] = []      # execution order
        self.outputs: list[str] = []                      # "Pass.channel"
        self.scene = None
        self.time_passes = False
        self.pass_events: list = []   # (pass, start, end) of the last run
        self._order: list[str] | None = None

    # --- construction (RenderGraph.h:96, 135, 198) -----------------------
    def create_pass(self, name: str, pass_type: str, props: dict | None = None):
        return self.add_pass(create_pass(pass_type, props), name)

    def add_pass(self, p: RenderPass, name: str):
        if name in self.passes:
            raise ValueError(f"pass '{name}' already in graph")
        p.name = name
        if self.scene is not None:
            p.set_scene(self.scene)
        self.passes[name] = p
        self._order = None
        return p

    def remove_pass(self, name: str):
        self.passes.pop(name)
        self.edges = [e for e in self.edges if name not in (e[0], e[2])]
        self.order_edges = [e for e in self.order_edges if name not in e]
        self.outputs = [o for o in self.outputs if o.split(".")[0] != name]
        self._order = None

    def add_edge(self, src: str, dst: str):
        """Data edge 'A.chan' -> 'B.chan', or an execution-order edge
        'A' -> 'B'."""
        if "." in src and "." in dst:
            sp, sc = src.split(".", 1)
            dp, dc = dst.split(".", 1)
            self.edges.append((sp, sc, dp, dc))
        else:
            self.order_edges.append((src.split(".")[0], dst.split(".")[0]))
        self._order = None

    def remove_edge(self, src: str, dst: str):
        self.edges = [e for e in self.edges
                      if not (f"{e[0]}.{e[1]}" == src
                              and f"{e[2]}.{e[3]}" == dst)]
        self.order_edges = [e for e in self.order_edges if e != (src, dst)]
        self._order = None

    def mark_output(self, name: str):
        if name not in self.outputs:
            self.outputs.append(name)

    def unmark_output(self, name: str):
        if name in self.outputs:
            self.outputs.remove(name)

    def get_pass(self, name: str) -> RenderPass:
        return self.passes[name]

    def set_scene(self, scene):
        self.scene = scene
        for p in self.passes.values():
            p.set_scene(scene)

    # camelCase names of the upstream Falcor bindings (scripts use both)
    def addPass(self, p: RenderPass, name: str):
        return self.add_pass(p, name)

    def addEdge(self, src: str, dst: str):
        return self.add_edge(src, dst)

    def removeEdge(self, src: str, dst: str):
        return self.remove_edge(src, dst)

    def markOutput(self, name: str):
        return self.mark_output(name)

    def unmarkOutput(self, name: str):
        return self.unmark_output(name)

    def removePass(self, name: str):
        return self.remove_pass(name)

    def getPass(self, name: str) -> RenderPass:
        return self.get_pass(name)

    # --- compilation --------------------------------------------------------
    def _execution_order(self) -> list[str]:
        """Kahn's algorithm, stable in pass insertion order."""
        if self._order is not None:
            return self._order
        deps = defaultdict(set)
        for sp, _, dp, _ in self.edges:
            deps[dp].add(sp)
        for sp, dp in self.order_edges:
            deps[dp].add(sp)
        indeg = {n: len(deps[n] & set(self.passes)) for n in self.passes}
        rev = defaultdict(list)
        for d, srcs in deps.items():
            for s in srcs:
                if s in self.passes and d in self.passes:
                    rev[s].append(d)
        q = deque(n for n in self.passes if indeg[n] == 0)
        order = []
        while q:
            n = q.popleft()
            order.append(n)
            for m in rev[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    q.append(m)
        if len(order) != len(self.passes):
            raise RuntimeError(f"render graph has a cycle involving "
                               f"{set(self.passes) - set(order)}")
        self._order = order
        return order

    # --- execution (RenderGraphExe.cpp:32-44) ------------------------------
    def init_state(self, ctx: RenderContext) -> dict:
        """The initial temporal state of every pass that keeps one."""
        state = {}
        for name in self._execution_order():
            s = self.passes[name].init_state(ctx)
            if s is not None:
                state[name] = s
        return state

    def execute(self, ctx: RenderContext, state: dict | None = None,
                external_inputs: dict | None = None):
        """Run every live pass once. external_inputs maps "Pass.channel" to
        a tensor (graph-level setInput, used by SVAO's nested SD graph).
        Returns (marked_outputs, all_channels, new_state).

        Only passes that contribute to a marked output (or declare no
        outputs) run; edges into a consumer's unused_inputs are dropped
        first."""
        state = state if state is not None else {}
        new_state = dict(state)
        unused = {n: frozenset(p.unused_inputs(ctx))
                  for n, p in self.passes.items()}
        eff_edges = [e for e in self.edges if e[3] not in unused[e[2]]]
        live = {o.split(".", 1)[0] for o in self.outputs}
        live |= {n for n, p in self.passes.items()
                 if not p.reflect(ctx).outputs}
        changed = True
        while changed:
            changed = False
            for sp, _, dp, _ in eff_edges:
                if dp in live and sp not in live:
                    live.add(sp)
                    changed = True
        in_edges = defaultdict(list)
        consumed = defaultdict(set)
        for sp, sc, dp, dc in eff_edges:
            if dp in live:
                in_edges[dp].append((dc, sp, sc))
                consumed[sp].add(sc)
        for o in self.outputs:
            op, oc = o.split(".", 1)
            consumed[op].add(oc)

        produced: dict[str, dict] = {}
        self.pass_events = []
        for name in self._execution_order():
            if name not in live:
                continue
            p = self.passes[name]
            inputs = {}
            for dc, sp, sc in in_edges[name]:
                src = produced.get(sp, {})
                if sc not in src:
                    raise KeyError(f"edge {sp}.{sc} -> {name}.{dc}: '{sc}' "
                                   f"not produced (has {list(src)})")
                inputs[dc] = src[sc]
            for key, val in (external_inputs or {}).items():
                kp, kc = key.split(".", 1)
                if kp == name:
                    inputs[kc] = val
            for ch in p.reflect(ctx).inputs:
                if not ch.optional and ch.name not in inputs:
                    raise KeyError(f"pass '{name}' ({p.pass_type}) missing "
                                   f"required input '{ch.name}'")
            ctx.consumed_outputs = frozenset(consumed[name])
            if self.time_passes:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with ctx.span(name):
                outputs, ns = p.execute(ctx, inputs, state.get(name))
            if self.time_passes:
                ev[1].record()
                self.pass_events.append((name, *ev))
            ctx.consumed_outputs = None
            produced[name] = outputs or {}
            if ns is not None:
                new_state[name] = ns
        marked = {o: self.get_output(o, produced) for o in self.outputs}
        return marked, produced, new_state

    def frame_fn(self, width: int, height: int, dictionary: dict | None = None,
                 profiler=None):
        """The per-frame call f(scene, state, frame_index, time,
        external_inputs) -> (marked_outputs, new_state); `profiler` times
        each pass under its name."""
        dictionary = dict(dictionary or {})

        def f(scene, state, frame_index=0, time=0.0, external_inputs=None):
            ctx = RenderContext(width=width, height=height, scene=scene,
                                frame_index=frame_index, time=time,
                                dictionary=dict(dictionary),
                                profiler=profiler)
            marked, _, new_state = self.execute(ctx, state, external_inputs)
            return marked, new_state

        return f

    def get_output(self, name: str, produced: dict):
        op, oc = name.split(".", 1)
        return produced[op][oc]

    def pass_times_ms(self) -> dict:
        """{pass: ms between its two CUDA events} of the last timed run
        (synchronizes). The span includes any time the stream waited for
        the host while the pass was enqueued."""
        if not self.pass_events:
            return {}
        torch.cuda.synchronize()
        return {n: a.elapsed_time(b) for n, a, b in self.pass_events}
