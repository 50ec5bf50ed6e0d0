"""Milliseconds a greedy step of the program's decode.step spans less their decode.sync_wait child (the host queuing the step), over decode.steps."""
from perfbench.core import readers


def read(ctx):
    return readers.decode_dispatch_ms_per_step(ctx)
