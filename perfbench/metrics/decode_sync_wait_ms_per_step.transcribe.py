"""Milliseconds a greedy step of the program's decode.sync_wait spans (the step's one host read), over decode.steps."""
from perfbench.core import readers


def read(ctx):
    return readers.decode_sync_wait_ms_per_step(ctx)
