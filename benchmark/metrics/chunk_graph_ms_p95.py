"""chunk_graph_ms_p95 (ms): the nearest-rank 95th percentile, over the
window's chunks, of a chunk graph's device time between its start and
end stamps (benchmark/spans.py, from the traced engines' stamps; set-up
chunks left out). Moves pose_latency_p95_ms."""

from benchmark.spans import figure


def read(ctx):
    return figure(ctx, "chunk_graph_ms_p95")
