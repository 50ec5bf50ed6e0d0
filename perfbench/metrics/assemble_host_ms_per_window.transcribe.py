"""Milliseconds a real window of the batched driver's result stage: the program's host_segmentize, host_assemble_suppress, host_result_build and host_regroup spans."""
from perfbench.core import readers


def read(ctx):
    return readers.host_phases_ms_per_window(ctx, readers.ASSEMBLE_PHASES)
