"""Milliseconds a real window encoded of the encoder's device time between CUDA events (the program's encoder.device_ms over encoder.windows)."""
from perfbench.core import readers


def read(ctx):
    return readers.encoder_device_ms_per_window(ctx)
