"""The batched driver's host phases (batched.HOST_PHASES, the timing wait left out) over the window, in %."""
from perfbench.core import readers


def read(ctx):
    return readers.driver_host_share(ctx)
