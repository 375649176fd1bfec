"""Render graph: a DAG of passes run in topological order (counterpart of
rtsdm_tpu/rendergraph/graph.py; reference RenderGraph.h, the compiler's
topological sort and liveness, RenderGraphCompiler.cpp:121-157). PyTorch
runs eagerly, so executing the graph dispatches pass by pass.
"""
from __future__ import annotations

from collections import defaultdict, deque

from .render_pass import RenderContext, RenderPass, create_pass


class RenderGraph:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.passes: dict[str, RenderPass] = {}
        self.edges: list[tuple[str, str, str, str]] = []  # sp, sc, dp, dc
        self.outputs: list[str] = []                      # "Pass.channel"
        self.scene = None
        self._order: list[str] | None = None

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

    def add_edge(self, src: str, dst: str):
        """Data edge 'A.chan' -> 'B.chan'."""
        sp, sc = src.split(".", 1)
        dp, dc = dst.split(".", 1)
        self.edges.append((sp, sc, dp, dc))
        self._order = None

    def mark_output(self, name: str):
        if name not in self.outputs:
            self.outputs.append(name)

    def set_scene(self, scene):
        self.scene = scene
        for p in self.passes.values():
            p.set_scene(scene)

    def _execution_order(self) -> list[str]:
        """Kahn's algorithm, stable in pass insertion order."""
        if self._order is not None:
            return self._order
        deps = defaultdict(set)
        for sp, _, dp, _ in self.edges:
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
            outputs, ns = p.execute(ctx, inputs, state.get(name))
            ctx.consumed_outputs = None
            produced[name] = outputs or {}
            if ns is not None:
                new_state[name] = ns
        marked = {o: produced[o.split(".", 1)[0]][o.split(".", 1)[1]]
                  for o in self.outputs}
        return marked, produced, new_state
