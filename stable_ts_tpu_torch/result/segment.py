"""Segment: an ordered list of words plus decode metadata.

Behavioral counterpart of the reference ``Segment``
(stable-ts stable_whisper/result.py:277-926). When a segment has words,
its start/end/text/tokens are *derived properties* of the words; otherwise a
plain segment-level payload backs them. Also provides the split-index finders
used by the regroup engine (gaps, punctuation, even length/duration splits).

Design notes (TPU build): the word-less payload lives in one ``_plain`` dict
instead of four parallel attributes, decode-quality metrics are declared once
in ``_METRICS`` and merged/serialized by iteration, and the even/greedy split
searches are factored into shared helpers used by both the length and the
duration finders.
"""
import re
import warnings
from copy import deepcopy
from itertools import chain
from typing import List, Optional, Tuple, TYPE_CHECKING, Union

import numpy as np

from ._common import combine_attr, group_words_by_lock, round_timestamp
from .word import WordTiming, _deprecated
from ..defaults import get_append_punctuations, get_min_word_dur
from ..stabilization.silence import suppress_silence as _suppress_silence
from ..utils import format_timestamp

if TYPE_CHECKING:  # pragma: no cover
    from .whisper_result import WhisperResult

# Words that look like initials/abbreviations/numbers ("U.S.", "Mr.", "3.")
# rather than sentence-final periods.
_SPECIAL_PERIOD_START = re.compile('^[A-Z0-9]')
_SPECIAL_PERIOD_STRIP = re.compile('[.A-Z0-9]')


class Segment:
    # decode-quality metrics carried through merges (averaged) and dict form
    _METRICS = ('temperature', 'avg_logprob', 'compression_ratio',
                'no_speech_prob')

    def __init__(self, start: Optional[float] = None,
                 end: Optional[float] = None, text: Optional[str] = None,
                 seek: Optional[float] = None,
                 tokens: Optional[List[int]] = None,
                 temperature: Optional[float] = None,
                 avg_logprob: Optional[float] = None,
                 compression_ratio: Optional[float] = None,
                 no_speech_prob: Optional[float] = None,
                 words: Optional[Union[List[WordTiming], List[dict]]] = None,
                 id: Optional[int] = None,
                 result: Optional['WhisperResult'] = None,
                 round_ts: bool = True, ignore_unused_args: bool = False):
        if words:
            if ignore_unused_args:
                start = end = text = tokens = None
            else:
                self._warn_shadowed(start, end, text, tokens)
        self.round_ts = round_ts
        # payload backing the properties when no words are present
        self._plain = dict(
            start=self.round(start) if start else 0.0,
            end=self.round(end) if end else 0.0,
            text=text or '',
            tokens=tokens or [])
        self.seek = seek
        for metric, value in zip(self._METRICS, (temperature, avg_logprob,
                                                 compression_ratio,
                                                 no_speech_prob)):
            setattr(self, metric, value)
        if words and isinstance(words[0], dict):
            words = [WordTiming(**fields, segment=self, round_ts=round_ts,
                                ignore_unused_args=True)
                     for fields in words]
        self.words = words
        self.id = id
        self.result = result

    @staticmethod
    def _warn_shadowed(start, end, text, tokens):
        if (start or end) is not None:
            warnings.warn('``start``/``end`` are ignored: with ``words`` present they '
                          'derive from the first and last word.', stacklevel=3)
        if text is not None:
            warnings.warn('``text`` is ignored: with ``words`` present it is the '
                          'concatenation of word texts.', stacklevel=3)
        if tokens is not None:
            warnings.warn('``tokens`` is ignored: with ``words`` present it is the '
                          'concatenation of word tokens.', stacklevel=3)

    # -- core protocol -------------------------------------------------------

    def __repr__(self):
        return f'Segment(start={self.start}, end={self.end}, text="{self.text}")'

    def __getitem__(self, index: int) -> WordTiming:
        if self.words is None:
            raise ValueError('segment contains no words')
        return self.words[index]

    def __delitem__(self, index: int):
        if self.words is None:
            raise ValueError('segment contains no words')
        del self.words[index]
        self.reassign_ids(index)

    def __deepcopy__(self, memo=None):
        return self.copy(copy_words=True, copy_tokens=True)

    def __copy__(self):
        return self.copy()

    def copy(self, new_words: Optional[List[WordTiming]] = None,
             keep_result: bool = False, copy_words: bool = False,
             copy_tokens: bool = False) -> 'Segment':
        if new_words is None:
            words = self.words if self.has_words else None
            plain = dict(self._plain)
        else:
            words = new_words
            plain = dict(start=None, end=None, text=None, tokens=None)
        if words is not None and copy_words:
            words = [w.copy(copy_tokens=copy_tokens) for w in words]
        # NB: with words present the constructor discards the plain payload
        # (it becomes word-derived) — same as the reference's copy().
        return Segment(
            seek=self.seek, words=words, id=self.id,
            result=self.result if keep_result else None,
            round_ts=self.round_ts, ignore_unused_args=True,
            **{m: getattr(self, m) for m in self._METRICS}, **plain)

    def round(self, timestamp: float) -> float:
        return round_timestamp(timestamp) if self.round_ts else timestamp

    # -- word-derived properties ----------------------------------------------

    @property
    def has_words(self) -> bool:
        return bool(self.words)

    @property
    def ori_has_words(self) -> bool:
        return self.words is not None

    @property
    def start(self) -> float:
        return self.words[0].start if self.has_words else self._plain['start']

    @start.setter
    def start(self, val: float):
        if self.has_words:
            self.words[0].start = val
        else:
            self._plain['start'] = self.round(val)

    @property
    def end(self) -> float:
        return self.words[-1].end if self.has_words else self._plain['end']

    @end.setter
    def end(self, val: float):
        if self.has_words:
            self.words[-1].end = val
        else:
            self._plain['end'] = self.round(val)

    @property
    def text(self) -> str:
        if self.has_words:
            return ''.join(w.word for w in self.words)
        return self._plain['text']

    @property
    def tokens(self) -> List[int]:
        if self.has_words and self.words[0].tokens:
            return list(chain.from_iterable(w.tokens for w in self.words))
        return self._plain['tokens']

    @property
    def duration(self) -> float:
        return self.end - self.start

    def word_count(self) -> int:
        return len(self.words) if self.has_words else -1

    def char_count(self) -> int:
        if self.has_words:
            return sum(len(w) for w in self.words)
        return len(self.text)

    # -- merging ----------------------------------------------------------------

    def add(self, other: 'Segment', copy_words: bool = False,
            newline: bool = False, reassign_ids: bool = True) -> 'Segment':
        if self.ori_has_words != other.ori_has_words:
            a, b = ('with' if s.ori_has_words else 'without' for s in (self, other))
            raise ValueError(f"Can't merge segment {a} words "
                             f'and a segment {b} words.')
        words = (self.words + other.words) if self.ori_has_words else None
        merged = self.copy(words, copy_words=copy_words)
        for metric in self._METRICS:
            combine_attr(merged, other, metric)
        merged._plain['end'] = other._plain['end']
        merged._plain['text'] += other._plain['text']
        merged._plain['tokens'] = merged._plain['tokens'] + other._plain['tokens']
        if newline:
            self._mark_newline(merged, boundary=len(self.words or self.text))
        if reassign_ids:
            merged.reassign_ids()
        return merged

    @staticmethod
    def _mark_newline(merged: 'Segment', boundary: int):
        """Force a line break at ``boundary`` (word count or char offset)."""
        if merged.has_words:
            last_of_first = merged.words[boundary - 1]
            if not last_of_first.word.endswith('\n'):
                last_of_first.word += '\n'
        elif merged.text[boundary - 1] != '\n':
            text = merged.text
            merged._plain['text'] = f'{text[:boundary]}\n{text[boundary:]}'

    def __add__(self, other: 'Segment') -> 'Segment':
        return self.add(other, copy_words=True)

    def add_words(self, index0: int, index1: int, inplace: bool = False) -> Optional[WordTiming]:
        if not self.has_words:
            return None
        joined = self.words[index0] + self.words[index1]
        if inplace:
            keep, drop = sorted((index0, index1))
            self.words[keep] = joined
            del self.words[drop]
        return joined

    def apply_min_dur(self, min_dur: float, inplace: bool = False) -> 'Segment':
        """Merge words shorter than ``min_dur`` into their shorter-side neighbor.

        Scans back-to-front; edge words merge inward, interior words merge
        toward whichever neighbor is currently shorter (reference
        result.py:536-560 order preserved — merge order affects the result).
        """
        segment = self if inplace else deepcopy(self)
        if not self.has_words:
            return segment
        last = len(segment.words) - 1
        for i in reversed(range(len(segment.words))):
            if last == 0:
                break
            if segment.words[i].duration >= min_dur:
                continue
            if i == last:
                pair = (i - 1, i)
            elif i == 0:
                pair = (i, i + 1)
            elif segment.words[i + 1].duration < segment.words[i - 1].duration:
                pair = (i - 1, i)
            else:
                pair = (i, i + 1)
            segment.add_words(*pair, inplace=True)
            last -= 1
        return segment

    # -- bulk word ops ------------------------------------------------------------

    def _word_operations(self, operation: str, *args, **kwargs):
        for w in self.words or ():
            getattr(w, operation)(*args, **kwargs)

    def offset_time(self, offset_seconds: float):
        if self.seek is not None:
            self.seek += offset_seconds
        if self.has_words:
            self._word_operations('offset_time', offset_seconds)
        else:
            self.start += offset_seconds
            self.end += offset_seconds

    def rescale_time(self, scale_factor: float):
        if self.seek is not None:
            self.seek *= scale_factor
        if self.has_words:
            self._word_operations('rescale_time', scale_factor)
        else:
            self.start *= scale_factor
            self.end *= scale_factor

    def suppress_silence(self, silent_starts: np.ndarray,
                         silent_ends: np.ndarray,
                         min_word_dur: Optional[float] = None,
                         word_level: bool = True,
                         nonspeech_error: float = 0.3,
                         use_word_position: bool = True) -> 'Segment':
        min_word_dur = get_min_word_dur(min_word_dur)
        if not self.has_words:
            _suppress_silence(self, silent_starts, silent_ends, min_word_dur,
                              nonspeech_error)
            return self
        targets = (self.words if word_level or len(self.words) == 1
                   else [self.words[0], self.words[-1]])
        if len(silent_starts) > 8 and len(targets) > 1:
            # One intersection pass per segment instead of three full-array
            # mask passes per word: every clipping rule only ever reads
            # sections that intersect the word, and clips move edges inward,
            # so sections intersecting the segment's original span are a
            # superset for the whole loop. Order is preserved -> identical
            # first-hit behavior.
            silent_starts = np.asarray(silent_starts, dtype=np.float64)
            silent_ends = np.asarray(silent_ends, dtype=np.float64)
            lo = min(w.start for w in targets)
            hi = max(w.end for w in targets)
            keep = (silent_ends > lo) & (silent_starts < hi)
            silent_starts = silent_starts[keep]
            silent_ends = silent_ends[keep]
        enders = get_append_punctuations()
        for i, w in enumerate(targets, 1):
            if use_word_position:
                keep_end = w.word[-1] not in enders and i != len(targets)
            else:
                keep_end = None
            w.suppress_silence(silent_starts, silent_ends, min_word_dur,
                               nonspeech_error, keep_end)
        return self

    # -- locks ----------------------------------------------------------------------

    @property
    def left_locked(self) -> bool:
        return self.has_words and self.words[0].left_locked

    @property
    def right_locked(self) -> bool:
        return self.has_words and self.words[-1].right_locked

    def lock_left(self):
        if self.has_words:
            self.words[0].lock_left()

    def lock_right(self):
        if self.has_words:
            self.words[-1].lock_right()

    def lock_both(self):
        self.lock_left()
        self.lock_right()

    def unlock_all_words(self):
        self._word_operations('unlock_both')

    def get_locked_indices(self) -> List[int]:
        """Indices i such that the boundary between word i and i+1 is locked."""
        return [i for i, (nxt, cur) in enumerate(zip(self.words[1:], self.words[:-1]))
                if nxt.left_locked or cur.right_locked]

    def words_by_lock(self, only_text: bool = True, include_single: bool = False):
        return group_words_by_lock(self.words, only_text=only_text,
                                   include_single=include_single)

    # -- split-index finders (for the regroup engine) --------------------------------

    def get_gaps(self, as_ndarray: bool = False):
        if not self.has_words:
            return []
        bounds = np.array([(w.start, w.end) for w in self.words])
        gaps = bounds[1:, 0] - bounds[:-1, 1]
        return gaps if as_ndarray else gaps.tolist()

    def get_gap_indices(self, max_gap: float = 0.1) -> List[int]:
        if not self.has_words or len(self.words) < 2:
            return []
        over = np.flatnonzero(self.get_gaps(True) > (max_gap or 0)).tolist()
        return sorted(set(over) - set(self.get_locked_indices()))

    def get_punctuation_indices(
            self, punctuation: Union[List[str], List[Tuple[str, str]], str]) -> List[int]:
        """Word indices after which a punctuation boundary occurs.

        A plain string matches a word ending with it (or, from the second
        word on, the *previous* index when a word starts with it); an
        (ending, beginning) pair must straddle the boundary exactly.
        """
        if not self.has_words or len(self.words) < 2:
            return []
        if isinstance(punctuation, str):
            punctuation = [punctuation]
        found: set = set()
        texts = [w.word for w in self.words]
        for p in punctuation:
            if isinstance(p, str):
                found.update(i for i, t in enumerate(texts[:-1]) if t.endswith(p))
                found.update(i - 1 for i, t in enumerate(texts[:-1])
                             if i and t.startswith(p) and not t.endswith(p))
            else:
                ending, beginning = p
                found.update(i for i in range(len(texts) - 1)
                             if texts[i].endswith(ending)
                             and texts[i + 1].startswith(beginning))
        return sorted(found - set(self.get_locked_indices()))

    def _get_special_period_indices(self, extra_indices: Optional[List[int]] = None) -> List[int]:
        indices = [i for i, word in enumerate(self.words)
                   if _SPECIAL_PERIOD_START.search(word.word)
                   and not word.word.endswith('..')
                   and len(_SPECIAL_PERIOD_STRIP.sub('', word.word)) < 3]
        if extra_indices:
            indices = sorted({*indices, *extra_indices})
        return indices

    def _get_even_split_indices(self, cumsum, parts_per_split: float,
                                splits: float,
                                excluded_indices: Optional[List[int]] = None) -> List[int]:
        """Pick split points closest to the ideal even-split targets.

        Excluded (locked) positions are remapped to their right neighbor so
        the argmin lands on a legal boundary.
        """
        cumsum = np.asarray(cumsum)
        targets = np.arange(1, int(splits)) * parts_per_split
        if not excluded_indices:
            return [int(np.abs(cumsum - t).argmin()) for t in targets]
        cumsum = cumsum.copy()
        lookup = np.arange(len(cumsum))
        banned = np.array(sorted(set(excluded_indices)))
        banned = banned[banned < len(self.words) - 1]
        if banned.size:
            cumsum[banned] = cumsum[banned + 1]
            lookup[banned] = banned + 1
        return sorted({int(lookup[np.abs(cumsum - t).argmin()]) for t in targets})

    def _greedy_split_indices(self, sizes: List[tuple], limits: tuple,
                              locked: List[int]) -> List[int]:
        """Split right before any word that pushes a running total past its limit."""
        indices: List[int] = []
        running = (0,) * len(limits)
        for i, size in enumerate(sizes):
            running = tuple(r + s for r, s in zip(running, size))
            overflow = any(cap is not None and r > cap
                           for r, cap in zip(running, limits))
            if i != 0 and overflow and i - 1 not in locked:
                indices.append(i - 1)
                running = size
        return indices

    def _excluded_for_splits(self, include_lock: bool,
                             ignore_special_periods: bool) -> List[int]:
        excluded = self.get_locked_indices() if include_lock else []
        if ignore_special_periods:
            excluded = self._get_special_period_indices(excluded)
        return excluded

    def get_length_indices(self, max_chars: Optional[int] = None,
                           max_words: Optional[int] = None,
                           even_split: bool = True, include_lock: bool = False,
                           ignore_special_periods: bool = False) -> List[int]:
        if not self.has_words or (max_chars is None and max_words is None):
            return []
        assert max_chars != 0 and max_words != 0, \
            f'max_chars and max_words must be greater than 0, but got {max_chars} and {max_words}'
        if len(self.words) < 2:
            return []
        excluded = self._excluded_for_splits(include_lock, ignore_special_periods)
        if not even_split:
            sizes = [(len(w.word), 1) for w in self.words]
            return self._greedy_split_indices(sizes, (max_chars, max_words),
                                              excluded)
        indices: List[int] = []
        char_total = -1 if max_chars is None else sum(map(len, self.words))
        word_total = -1 if max_words is None else len(self.words)
        over_chars = max_chars is not None and char_total > max_chars
        over_words = max_words is not None and word_total > max_words
        if over_chars:
            splits = np.ceil(char_total / max_chars)
            cum_chars = np.cumsum([len(w.word) for w in self.words[:-1]])
            indices = self._get_even_split_indices(
                cum_chars, char_total / splits, splits, excluded)
            if max_words is not None:
                spans = zip([0] + indices, indices + [len(self.words)])
                over_words = any(j - i + 1 > max_words for i, j in spans)
        if over_words:
            splits = np.ceil(word_total / max_words)
            cum_words = np.arange(1, len(self.words) + 1)
            indices = self._get_even_split_indices(
                cum_words, word_total / splits, splits, excluded)
        return indices

    def get_duration_indices(self, max_dur: float, even_split: bool = True,
                             include_lock: bool = False,
                             ignore_special_periods: bool = False) -> List[int]:
        if not self.has_words:
            return []
        durations = [w.duration for w in self.words]
        total = float(np.sum(durations))
        if total <= max_dur:
            return []
        excluded = self._excluded_for_splits(include_lock, ignore_special_periods)
        if even_split:
            splits = np.ceil(total / max_dur)
            cum_dur = np.cumsum(durations[:-1])
            return self._get_even_split_indices(cum_dur, total / splits,
                                                splits, excluded)
        return self._greedy_split_indices([(d,) for d in durations],
                                          (max_dur,), excluded)

    def split(self, indices: List[int], reassign_ids: bool = True) -> List['Segment']:
        """Split after each word index in ``indices`` into new segments."""
        if not indices:
            return []
        if indices[-1] != len(self.words) - 1:
            indices.append(len(self.words) - 1)
        bounds = zip([0] + [i + 1 for i in indices[:-1]],
                     [i + 1 for i in indices])
        pieces = []
        for lo, hi in bounds:
            chunk = self.words[lo:hi]
            if not chunk:
                continue
            piece = self.copy(chunk, copy_words=False)
            if reassign_ids:
                piece.reassign_ids()
            pieces.append(piece)
        return pieces

    # -- bookkeeping ---------------------------------------------------------------

    def reassign_ids(self, start: Optional[int] = None):
        for i, word in enumerate((self.words or ())[start:], start or 0):
            word.segment = self
            word.id = i

    def convert_to_segment_level(self):
        if not self.has_words:
            return
        self._plain = dict(start=self.start, end=self.end, text=self.text,
                           tokens=self.tokens)
        self.words = None

    # -- deprecated shims (reference result.py:674-679 etc.) ---------------------------

    def round_all_timestamps(self):
        _deprecated('.round_all_timestamps()', 'round_ts=True')
        self.round_ts = True
        for word in self.words or ():
            word.round_ts = True

    def update_seg_with_words(self):
        warnings.warn('Segment attributes are word-derived properties; '
                      '``update_seg_with_words()`` is deprecated. Use '
                      '``.reassign_ids()`` to update ids.', stacklevel=2)
        self.reassign_ids()

    def set_result(self, result):
        _deprecated('.set_result()', '.result = ...')
        self.result = result

    def get_result(self):
        _deprecated('.get_result()', '.result')
        return self.result

    # -- serialization ----------------------------------------------------------------

    def _reversed_words(self, prepend_punctuations: Optional[str] = None,
                        append_punctuations: Optional[str] = None):
        """Word dicts in CHRONOLOGICAL order with per-word punctuation swapped
        for RTL rendering (reference result.py:562-607 ``_to_reverse_text``).
        The renderer (text_output.words2segments) reverses display order via
        the ``reversed_text`` marker; word timestamps stay chronological."""
        from ..defaults import get_prepend_punctuations
        prepend = get_prepend_punctuations(prepend_punctuations)
        if prepend and ' ' not in prepend:
            prepend += ' '
        append = get_append_punctuations(append_punctuations)
        words = (self.words if self.has_words else
                 [WordTiming(word=w, start=0, end=1, probability=0)
                  for w in self.text.split(' ')])
        out = []
        for word in words:
            text = word.word
            moved_right = ''
            while text and text[0] in prepend:
                moved_right += text[0]
                text = text[1:]
            moved_left = ''
            while text and text[-1] in append:
                moved_left += text[-1]
                text = text[:-1]
            fields = word.to_dict()
            fields['word'] = f'{moved_left}{text}{moved_right[::-1]}'
            out.append(fields)
        return out

    def to_dict(self, reverse_text: Union[bool, tuple] = False) -> dict:
        payload = dict(start=self.start, end=self.end, text=self.text,
                       seek=self.seek,
                       tokens=None if self.tokens is None else list(self.tokens))
        payload.update({m: getattr(self, m) for m in self._METRICS})
        if reverse_text:
            args = reverse_text if isinstance(reverse_text, tuple) else ()
            rwords = self._reversed_words(*args)
            payload['text'] = ''.join(w['word'] for w in reversed(rwords))
            if self.has_words:
                payload['words'] = rwords
            elif self.ori_has_words:
                payload['words'] = []
            payload['reversed_text'] = True
        elif self.has_words:
            payload['words'] = [w.to_dict() for w in self.words]
        elif self.ori_has_words:
            payload['words'] = []
        return payload

    def to_display_str(self, only_segment: bool = False) -> str:
        line = f'[{format_timestamp(self.start)} --> {format_timestamp(self.end)}] "{self.text}"'
        if self.has_words and not only_segment:
            line += '\n' + '\n'.join(f'-{w.to_display_str()}' for w in self.words) + '\n'
        return line
