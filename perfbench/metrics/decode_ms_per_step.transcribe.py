"""Milliseconds of the greedy loop (synchronized at each end) per decoder step, over the window."""
from perfbench.core import readers


def read(ctx):
    return readers.span_ms_per(ctx, 'greedy_loop', 'decoder_step')
