"""Tiny helper for data-driven graph construction. The PASS/EDGE/OUTPUT
tables in each script preserve the reference pipelines' pass names and
channel contracts (SURVEY §2.4) so the same script-level description drives
both engines; construction style is our own."""
from falcor import RenderGraph


def build(name, passes, edges, outputs):
    g = RenderGraph(name)
    for pname, ptype, props in passes:
        g.create_pass(pname, ptype, props)
    for src, dst in edges:
        g.add_edge(src, dst)
    for o in outputs:
        g.mark_output(o)
    return g
