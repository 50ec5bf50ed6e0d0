"""Audio seconds transcribed per wall second: all audio of the window's requests over all its time, SRT included."""
from perfbench.core import readers


def read(ctx):
    return readers.audio_rate(ctx)
