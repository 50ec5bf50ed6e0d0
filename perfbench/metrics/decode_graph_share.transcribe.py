"""The program's decode.graph_replays over decode.graph_replays + decode.eager_steps: decoder steps replayed from a CUDA graph, in %."""
from perfbench.core import readers


def read(ctx):
    return readers.decode_graph_share(ctx)
