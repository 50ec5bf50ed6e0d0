"""The program's decode.tokens_kept over decode.row_steps: the share of the greedy loops' row steps that made a kept token, in %."""
from perfbench.core import readers


def read(ctx):
    return readers.decode_row_use(ctx)
