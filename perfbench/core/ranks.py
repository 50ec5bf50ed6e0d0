"""The benchmark's synthetic rank table, the size of Whisper's multilingual
vocabulary (50257 ids below the special tokens).

It is built by a fixed rule, the same in every run:

- ids 0-255: the 256 single bytes;
- 35000 "word" tokens, a space and 1-4 lowercase letters, every prefix of
  each ranked before it (all of 1-3 letters, and an evenly strided share
  of the 4-letter ones), so that a word of the table encodes to one token;
- the rest, 15001 continuation tokens of 2-3 uppercase letters (all of 2,
  a strided share of 3), which start no word.

So about 70 % of the ids start a word with a space: random ids decode to
words of about 1.4 tokens (the generated text's word splitting, regroup
and SRT do the host work real text makes them do), and a transcript word
made of a word token and one continuation token encodes to 2 tokens.
Byte-level BPE over this table merges only a space into lowercase letters
and uppercase letters into each other, never across the two.
"""
import string
from functools import lru_cache
from typing import Dict, List

N_BASE = 50257
N_WORD = 35000


def _strided(items: List[str], count: int) -> List[str]:
    """``count`` of ``items`` at evenly spaced positions, in order."""
    if count >= len(items):
        return list(items)
    return [items[(i * len(items)) // count] for i in range(count)]


def _strings(alphabet: str, length: int) -> List[str]:
    out = ['']
    for _ in range(length):
        out = [s + c for s in out for c in alphabet]
    return out


@lru_cache(maxsize=1)
def word_tokens() -> tuple:
    """The word tokens (without their leading space), in rank order."""
    lower = string.ascii_lowercase
    words = _strings(lower, 1) + _strings(lower, 2) + _strings(lower, 3)
    words += _strided(_strings(lower, 4), N_WORD - len(words))
    return tuple(words)


@lru_cache(maxsize=1)
def continuation_tokens() -> tuple:
    """The continuation tokens, in rank order."""
    upper = string.ascii_uppercase
    n = N_BASE - 256 - N_WORD
    conts = _strings(upper, 2)
    conts += _strided(_strings(upper, 3), n - len(conts))
    return tuple(conts)


@lru_cache(maxsize=1)
def rank_table() -> Dict[bytes, int]:
    """bytes -> id for the 50257 base ids."""
    ranks = {bytes([b]): b for b in range(256)}
    for w in word_tokens():
        ranks[(' ' + w).encode()] = len(ranks)
    for c in continuation_tokens():
        ranks[c.encode()] = len(ranks)
    if len(ranks) != N_BASE:
        raise AssertionError(f'rank table has {len(ranks)} ids, not {N_BASE}')
    return ranks
