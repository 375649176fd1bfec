"""pass_ms.GBufferRaster: the GBufferRaster pass's CUDA-event span (RenderGraph.time_passes:
the events the graph records around the pass, stream waits for the host
included), mean per window frame of the traced run."""
LAYER = "Graph / passes (rendergraph/, passes/)"
MOVES = "frame_ms"
PASS = "GBufferRaster"


def read(r):
    spans = r.get("pass_ms", {}).get(PASS)
    return sum(spans) / len(spans) if spans else None
