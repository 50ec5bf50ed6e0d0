"""Seconds from the process's start to the window's: imports, the CUDA context, the kernel build check, the weights and the warm-up."""
from perfbench.core import readers


def read(ctx):
    return readers.setup(ctx)
