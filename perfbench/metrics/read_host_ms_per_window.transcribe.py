"""Milliseconds a real window of the batched driver's read stage: the program's host_load, host_silence_predict and host_window_stack spans."""
from perfbench.core import readers


def read(ctx):
    return readers.host_phases_ms_per_window(ctx, readers.READ_PHASES)
