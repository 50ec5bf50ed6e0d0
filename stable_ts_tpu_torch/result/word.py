"""Word-level timing record.

Behavioral counterpart of the reference ``WordTiming``
(stable-ts stable_whisper/result.py:74-257): a mutable record of one
word's text, [start, end] span, decode probability, source tokens, and lock
flags that protect its boundaries from regrouping edits.

Design notes (TPU build): timestamps live behind a rounding data descriptor
(3 dp = finer than the 20 ms token grid) instead of hand-written
property/setter pairs, and serialization is driven by a payload field tuple
so the record schema is stated once.
"""
import warnings
from typing import List, Optional, TYPE_CHECKING

import numpy as np

from ._common import round_timestamp
from ..utils import format_timestamp
from ..stabilization.silence import suppress_silence as _suppress_silence

if TYPE_CHECKING:  # pragma: no cover
    from .segment import Segment


class _Rounded:
    """Data descriptor: a timestamp rounded on write unless the owner opts out."""
    __slots__ = ('slot',)

    def __set_name__(self, owner, name):
        self.slot = '_' + name

    def __get__(self, obj, objtype=None):
        return self if obj is None else getattr(obj, self.slot)

    def __set__(self, obj, value):
        setattr(obj, self.slot, obj.round(value))


def _deprecated(old: str, new: str):
    warnings.warn(f'``{old}`` is deprecated. Use ``{new}`` instead.', stacklevel=3)


class WordTiming:
    # keys that appear in dict/JSON form, in schema order
    _PAYLOAD = ('word', 'start', 'end', 'probability', 'tokens')

    __slots__ = ('round_ts', 'word', '_start', '_end', 'probability', 'tokens',
                 'left_locked', 'right_locked', 'segment', 'id')

    start = _Rounded()
    end = _Rounded()

    def __init__(self, word: str, start: float, end: float,
                 probability: Optional[float] = None,
                 tokens: Optional[List[int]] = None,
                 left_locked: bool = False, right_locked: bool = False,
                 segment_id: Optional[int] = None, id: Optional[int] = None,
                 segment: Optional['Segment'] = None, round_ts: bool = True,
                 ignore_unused_args: bool = False):
        if segment_id is not None and not ignore_unused_args:
            warnings.warn('``segment_id`` is ignored; pass the owning segment '
                          'via ``segment``.', stacklevel=2)
        self.round_ts = round_ts
        self.word, self.start, self.end = word, start, end
        self.probability, self.tokens = probability, tokens
        self.left_locked, self.right_locked = left_locked, right_locked
        self.segment, self.id = segment, id

    # -- core protocol -----------------------------------------------------

    def __repr__(self):
        return f'WordTiming(start={self.start}, end={self.end}, word="{self.word}")'

    def __len__(self):
        return len(self.word)

    def __add__(self, other: 'WordTiming') -> 'WordTiming':
        """Concatenate text, take the union span, average/extend metadata.

        A None on either side poisons the merged metadata to None so a merged
        value is never half-informed (reference result.py:23-33 semantics).
        """
        a, b = self.probability, other.probability
        t, u = self.tokens, other.tokens
        return WordTiming(
            self.word + other.word,
            min(self.start, other.start), max(self.end, other.end),
            probability=None if (a is None or b is None) else (a + b) / 2,
            tokens=None if (t is None or u is None) else [*t, *u],
            left_locked=self.left_locked or other.left_locked,
            right_locked=self.right_locked or other.right_locked,
            id=self.id, segment=self.segment)

    def __deepcopy__(self, memo=None):
        return self.copy(copy_tokens=True)

    def __copy__(self):
        return self.copy()

    def copy(self, keep_segment: bool = False, copy_tokens: bool = False) -> 'WordTiming':
        dup = WordTiming(self.word, self.start, self.end,
                         probability=self.probability, tokens=self.tokens,
                         left_locked=self.left_locked,
                         right_locked=self.right_locked,
                         id=self.id, round_ts=self.round_ts,
                         segment=self.segment if keep_segment else None)
        if copy_tokens and dup.tokens is not None:
            dup.tokens = list(dup.tokens)
        return dup

    # -- timestamps ---------------------------------------------------------

    def round(self, timestamp: float) -> float:
        return round_timestamp(timestamp) if self.round_ts else timestamp

    @property
    def duration(self) -> float:
        return self.round(self.end - self.start)

    @property
    def segment_id(self) -> Optional[int]:
        return getattr(self.segment, 'id', None)

    def offset_time(self, offset_seconds: float):
        self.start += offset_seconds
        self.end += offset_seconds

    def rescale_time(self, scale_factor: float):
        self.start *= scale_factor
        self.end *= scale_factor

    def clamp_max(self, max_dur: float, clip_start: bool = False, verbose: bool = False):
        """Shrink duration to ``max_dur`` by moving one boundary toward the other."""
        if self.duration <= max_dur:
            return
        if clip_start:
            moved = round(self.end - max_dur, 3)
            report = f'Start: {self.start} -> {moved}\nEnd: {self.end}'
            self.start = moved
        else:
            moved = round(self.start + max_dur, 3)
            report = f'Start: {self.start}\nEnd: {self.end} -> {moved}'
            self.end = moved
        if verbose:
            print(f'{report}\nText:"{self.word}"\n')

    def suppress_silence(self, silent_starts: np.ndarray, silent_ends: np.ndarray,
                         min_word_dur: Optional[float] = None,
                         nonspeech_error: float = 0.3,
                         keep_end: Optional[bool] = True) -> 'WordTiming':
        _suppress_silence(self, silent_starts, silent_ends, min_word_dur,
                          nonspeech_error, keep_end)
        return self

    # -- locks ---------------------------------------------------------------

    def lock_left(self):
        self.left_locked = True

    def lock_right(self):
        self.right_locked = True

    def lock_both(self):
        self.left_locked = self.right_locked = True

    def unlock_both(self):
        self.left_locked = self.right_locked = False

    # -- deprecated shims (reference result.py:185-257) ------------------------

    def round_all_timestamps(self):
        _deprecated('.round_all_timestamps()', 'round_ts=True')
        self.round_ts = True

    def set_segment(self, segment):
        _deprecated('.set_segment()', '.segment = ...')
        self.segment = segment

    def get_segment(self):
        _deprecated('.get_segment()', '.segment')
        return self.segment

    # -- serialization --------------------------------------------------------

    def to_dict(self) -> dict:
        payload = {key: getattr(self, key) for key in self._PAYLOAD}
        if payload['tokens'] is not None:
            payload['tokens'] = list(payload['tokens'])
        return payload

    def to_display_str(self) -> str:
        span = ' -> '.join(f'[{format_timestamp(t)}]' for t in (self.start, self.end))
        return f'{span} "{self.word}"'
