"""Model operations of the useful work over the window's seconds at 989 TFLOP/s (H100 SXM bf16 dense), in %."""
from perfbench.core import readers


def read(ctx):
    return readers.mfu(ctx)
