"""The kernel wrappers' summed bound time over their summed device time in the profiled span, in % (perfbench/roofline.py)."""
from perfbench.core import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
