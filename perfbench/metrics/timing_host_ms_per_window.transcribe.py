"""Milliseconds a real window (batched.windows_real) of the program's host_timing_finish spans less their timing.wait: the word timing's host work."""
from perfbench.core import readers


def read(ctx):
    return readers.timing_host_ms_per_window(ctx)
