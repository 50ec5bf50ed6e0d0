"""The share of the profiled span in which no operation ran on the device, in %."""
from perfbench.core import readers


def read(ctx):
    return readers.device_idle(ctx)
