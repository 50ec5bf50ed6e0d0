"""Milliseconds of WhisperTorch.embed_audio (synchronized at each end) per real window encoded."""
from perfbench.core import readers


def read(ctx):
    return readers.encoder_ms_per_window(ctx)
