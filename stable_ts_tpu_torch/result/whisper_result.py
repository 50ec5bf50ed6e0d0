"""WhisperResult: the mutable word/segment tree plus the regroup engine.

Behavioral counterpart of the reference ``WhisperResult``
(stable-ts stable_whisper/result.py:928-3102): holds the pristine
``ori_dict``, the live segment list, nonspeech sections, and a replayable
``regroup_history``; exposes 20+ chainable split/merge/edit operations and the
compact regroup DSL (``sg=.5_sp=,* /，++++50_sl=70_cm`` ...).

Design notes (TPU build): token normalization shared by the removal/gap-fill
operations lives in one module helper, the custom-operation rule engine is
decomposed into per-verb action builders, and the DSL key table is declared
as data. All user-visible strings (history entries, prints, exceptions) are
byte-compatible with the reference.
"""
import re
import warnings
from copy import deepcopy
from itertools import chain
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ._common import ContentCache, group_words_by_lock, round_timestamp
from .segment import Segment, _SPECIAL_PERIOD_START, _SPECIAL_PERIOD_STRIP
from .word import WordTiming
from ..defaults import get_min_word_dur
from ..text_output import (load_result, result_to_ass, result_to_srt_vtt,
                           result_to_tsv, result_to_txt, save_as_json)
from ..utils import UnsortedException, str_to_valid_type, format_timestamp

__all__ = ['WhisperResult']

# Default regroup chain (reference result.py:3008).
DEFAULT_REGROUP_ALGO = 'isp_cm_sp=.* /。/?/？_sg=.5_sp=,* /，++++50_sl=70_cm'

# DSL key -> method name, in the reference's declaration order (the order is
# user-visible through error messages listing the available methods).
_DSL_METHODS = dict(
    sg='split_by_gap', sp='split_by_punctuation', sl='split_by_length',
    sd='split_by_duration', mg='merge_by_gap', mp='merge_by_punctuation',
    ms='merge_all_segments', cm='clamp_max', us='unlock_all_segments',
    l='lock', rw='remove_word', rs='remove_segment', rp='remove_repetition',
    rws='remove_words_by_str', fg='fill_in_gaps', p='pad', ag='adjust_gaps',
    csl='convert_to_segment_level', co='custom_operation',
    isp='ignore_special_periods')

# Comparison operators accepted by custom_operation.
_COMPARATORS = {
    '==': lambda a, b: a == b,
    '>': lambda a, b: a > b,
    '>=': lambda a, b: a >= b,
    '<': lambda a, b: a < b,
    '<=': lambda a, b: a <= b,
    'is': lambda a, b: a is b,
    'in': lambda a, b: a in b,
    'start': str.startswith,
    'end': str.endswith,
}


def _normalize_tokens(texts: List[str], case_sensitive: bool, strip: bool,
                      ignore_punctuations: str) -> List[str]:
    """Canonicalize word texts for matching: strip -> drop trailing
    punctuation -> casefold (same transform order as the reference)."""
    if strip:
        texts = [t.strip() for t in texts]
    if ignore_punctuations:
        tail = f'[{ignore_punctuations}]+$'
        texts = [re.sub(tail, '', t) for t in texts]
    if not case_sensitive:
        texts = [t.lower() for t in texts]
    return texts


def _copy_data(x):
    """Deep-copy plain JSON-like data (dict/list/scalars) without the
    generic ``copy.deepcopy`` memo machinery — ~10x faster on the large
    ``ori_dict`` payloads a long transcription carries."""
    t = type(x)
    if t is dict:
        return {k: _copy_data(v) for k, v in x.items()}
    if t is list:
        return [_copy_data(v) for v in x]
    if t is tuple:
        return tuple(_copy_data(v) for v in x)
    return x


def _describe_part(part, is_word: bool) -> str:
    """Multi-line human-readable summary used in unsorted-timestamp dumps."""
    lines = [f'Segment ID: {part.segment_id if is_word else part.id}']
    if is_word:
        lines.append(f'Word ID: {part.id}')
    lines += [f'Start: {part.start}', f'End: {part.end}',
              f'Text: "{part.word if is_word else part.text}"']
    return '\n'.join(lines)


class WhisperResult:

    def __init__(self, result: Union[str, dict, list],
                 force_order: bool = False,
                 check_sorted: Union[bool, str] = True,
                 show_unsorted: bool = True):
        result, self.path = self._standardize_result(result)
        self.ori_dict = result.get('ori_dict') or result
        self.language = self.ori_dict.get('language')
        self._regroup_history = result.get('regroup_history', '')
        self._nonspeech_sections = result.get('nonspeech_sections') or []
        self.unfinished_start: float = result.get('unfinished', -1.0)
        self._forced_order = force_order
        segments = (result.get('segments', self.ori_dict.get('segments')) or {}).copy()
        self._materialize(segments, check_sorted, show_unsorted)
        self._ignore_special_periods = False
        self._content_cache = ContentCache()

    # -- construction ---------------------------------------------------------

    @staticmethod
    def _standardize_result(result) -> Tuple[dict, Optional[str]]:
        """Accept a JSON path, a result dict, a list of segment dicts, or a
        list of lists of word dicts; normalize to a result dict."""
        path = None
        if isinstance(result, str):
            path = result
            result = load_result(path)
        if isinstance(result, dict):
            return result, path
        if not isinstance(result, list):
            raise TypeError(f'Expected result to be list but got {type(result)}')
        if not result or not result[0]:
            return {}, path
        head = result[0]
        if isinstance(head, dict):
            return dict(segments=result), path
        if not isinstance(head, list):
            raise NotImplementedError(
                f'Got list of {type(head)} but expected list of list/dict')
        if not isinstance(head[0], dict):
            raise NotImplementedError(
                f'Got list of list of {type(head[0])} but expected dicts')
        segments = [dict(start=words[0]['start'], end=words[-1]['end'],
                         text=''.join(w['word'] for w in words), words=words)
                    for words in result if words]
        return dict(segments=segments), path

    def _materialize(self, segment_dicts,
                     check_sorted: Union[bool, str] = False,
                     show_unsorted: bool = True):
        """(Re)build the live segment objects and run the ordering guards."""
        self.segments = ([Segment(**fields, ignore_unused_args=True)
                          for fields in segment_dicts]
                         if segment_dicts else [])
        if self._forced_order:
            self.force_order()
        if check_sorted is not False:
            self.raise_for_unsorted(check_sorted, show_unsorted)
        self.remove_no_word_segments(
            any(seg.has_words for seg in self.segments))

    # -- core protocol -----------------------------------------------------------

    def __deepcopy__(self, memo=None):
        """Fast deep copy: segments/words reconstruct through their own
        ``copy()`` fast paths and ``ori_dict`` is plain data, so direct
        rebuilding beats generic ``copy.deepcopy`` ~8x on long results.
        Matches the generic semantics exactly: backrefs reset to ``None``
        (``segment.result`` / ``word.segment``), fresh ``ContentCache``
        with the same stored items. ``to_srt_vtt``'s non-inplace
        ``apply_min_dur`` is the hot caller (reference result.py renders
        through the same copy)."""
        dup = object.__new__(type(self))
        state = self.__dict__.copy()
        state['ori_dict'] = _copy_data(self.ori_dict)
        state['_nonspeech_sections'] = _copy_data(self._nonspeech_sections)
        cache = ContentCache()
        cache._items = dict(self._content_cache._items)
        state['_content_cache'] = cache
        state['segments'] = [s.copy(copy_words=True, copy_tokens=True)
                             for s in self.segments]
        dup.__dict__.update(state)
        return dup

    def __getitem__(self, index: int) -> Segment:
        return self.segments[index]

    def __delitem__(self, index: int):
        del self.segments[index]
        self.reassign_ids(True, start=index)

    def __len__(self):
        return len(self.segments)

    @property
    def duration(self) -> float:
        if not self.segments:
            return 0.0
        return round_timestamp(self.segments[-1].end - self.segments[0].start)

    @property
    def text(self) -> str:
        return ''.join(s.text for s in self.segments)

    @property
    def regroup_history(self) -> str:
        return self._regroup_history

    @property
    def nonspeech_sections(self) -> List[dict]:
        return self._nonspeech_sections

    @property
    def has_words(self) -> bool:
        return bool(self.segments) and all(seg.has_words for seg in self.segments)

    # -- ordering guards ------------------------------------------------------------

    def force_order(self):
        """Repair out-of-order timestamps from untrusted backends in place.

        Walks forward keeping a floor (= latest end seen); a start below the
        floor is raised to it, and a start past its own end either collapses
        the part or rewinds earlier parts down to the offending end.
        """
        parts = self.all_words_or_segments()
        floor = 0
        for i, part in enumerate(parts):
            if part.start < floor:
                part.start = floor
            if part.start > part.end:
                if floor > part.end:
                    warnings.warn('Multiple consecutive timestamps are out of order. '
                                  'Some parts will have no duration.')
                    part.start = part.end
                    self._rewind_ends(parts, i - 1, part.end)
                elif part.start != floor:
                    part.start = floor
                else:
                    is_last = i + 1 == len(parts)
                    part.end = part.start if is_last else parts[i + 1].start
            floor = part.end

    @staticmethod
    def _rewind_ends(parts, last_index: int, limit: float):
        """Clamp every timestamp after ``limit`` in parts[:last_index+1]."""
        for j in range(last_index, -1, -1):
            if parts[j].end > limit:
                parts[j].end = limit
            if parts[j].start > limit:
                parts[j].start = limit

    def raise_for_unsorted(self, check_sorted: Union[bool, str] = True,
                           show_unsorted: bool = True):
        """Raise (or dump diagnostics to a JSON path) if timestamps regress."""
        if check_sorted is False:
            return
        all_parts = self.all_words_or_segments()
        if not all_parts:
            return
        is_word = isinstance(all_parts[0], WordTiming)
        timeline = np.array([t for p in all_parts for t in (p.start, p.end)])
        if len(timeline) < 2:
            return
        regressions = np.flatnonzero(timeline[:-1] > timeline[1:])
        if not regressions.size:
            return
        if show_unsorted:
            for k in regressions:
                part = all_parts[k // 2]
                info = _describe_part(part, is_word)
                if k % 2:  # this part's end vs the next part's start
                    nxt = all_parts[k // 2 + 1]
                    info += (f'\nConflict: end ({part.end}) > '
                             f'next start ({nxt.start})\n'
                             + _describe_part(nxt, is_word))
                else:      # within one part: start vs end
                    info += f'\nConflict: start ({part.start}) > end ({part.end})'
                print(info, end='\n\n')
        data = self.to_dict()
        if check_sorted is True:
            raise UnsortedException(data=data)
        warnings.warn('Timestamps are not in ascending order. If data is produced by '
                      'this library, please submit an issue with the saved data.')
        save_as_json(data, check_sorted)

    # -- bookkeeping -------------------------------------------------------------------

    def reassign_ids(self, only_segments: bool = False, start: Optional[int] = None):
        for i, seg in enumerate(self.segments[start:], start or 0):
            seg.id = i
            seg.result = self
            if not only_segments:
                seg.reassign_ids()

    def remove_no_word_segments(self, ignore_ori: bool = False, reassign_ids: bool = True):
        self.segments = [
            seg for seg in self.segments
            if seg.has_words or not (ignore_ori or seg.ori_has_words)]
        if reassign_ids:
            self.reassign_ids()

    def update_nonspeech_sections(self, silent_starts, silent_ends, overwrite: bool = True):
        sections = [dict(start=round(float(s), 3), end=round(float(e), 3))
                    for s, e in zip(silent_starts, silent_ends)]
        if overwrite:
            self._nonspeech_sections = sections
        else:
            self._nonspeech_sections += sections

    def _update_history(self, changes: str):
        if changes:
            joiner = '_' if self._regroup_history else ''
            self._regroup_history = f'{self._regroup_history}{joiner}{changes}'

    # -- accessors -----------------------------------------------------------------------

    def all_words(self) -> List[WordTiming]:
        return [w for seg in self.segments for w in seg.words]

    def all_words_or_segments(self):
        return self.all_words() if self.has_words else self.segments

    def all_words_by_lock(self, only_text: bool = True, by_segment: bool = False,
                          include_single: bool = False):
        if by_segment:
            return [seg.words_by_lock(only_text=only_text, include_single=include_single)
                    for seg in self.segments]
        return group_words_by_lock(self.all_words(), only_text=only_text,
                                   include_single=include_single)

    def all_tokens(self) -> List[int]:
        return [t for w in self.all_words() for t in w.tokens]

    def get_content_by_time(self, time: Union[float, Tuple[float, float], dict],
                            within: bool = False, segment_level: bool = False):
        """Return words (or segments) overlapping / within the ``time`` range."""
        if not segment_level and not self.has_words:
            raise ValueError('Missing word timestamps in result. '
                             'Use ``segment_level=True`` instead.')
        contents = self.segments if segment_level else self.all_words()
        if isinstance(time, (float, int)):
            start = end = time
        elif isinstance(time, dict):
            start, end = time['start'], time['end']
        else:
            start, end = time
        if within:
            return [c for c in contents if start <= c.start and c.end <= end]
        return [c for c in contents if start <= c.end and c.start <= end]

    def get_locked_indices(self) -> List[int]:
        return [i for i, (nxt, cur) in enumerate(zip(self.segments[1:], self.segments[:-1]))
                if nxt.left_locked or cur.right_locked]

    def get_gaps(self, as_ndarray: bool = False):
        if not self.segments:
            gaps = np.array([])
        else:
            bounds = np.array([(s.start, s.end) for s in self.segments])
            gaps = bounds[1:, 0] - bounds[:-1, 1]
        return gaps if as_ndarray else gaps.tolist()

    def get_gap_indices(self, min_gap: float = 0.1) -> List[int]:
        if len(self.segments) < 2:
            return []
        under = np.flatnonzero(self.get_gaps(True) <= (min_gap or 0)).tolist()
        return sorted(set(under) - set(self.get_locked_indices()))

    def get_punctuation_indices(self, punctuation) -> List[int]:
        if len(self.segments) < 2:
            return []
        if isinstance(punctuation, str):
            punctuation = [punctuation]
        found: set = set()
        texts = [s.text for s in self.segments]
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

    # -- time adjustment -----------------------------------------------------------------

    def offset_time(self, offset_seconds: float):
        for s in self.segments:
            s.offset_time(offset_seconds)

    def rescale_time(self, scale_factor: float):
        for s in self.segments:
            s.rescale_time(scale_factor)

    def apply_min_dur(self, min_dur: float, inplace: bool = False) -> 'WhisperResult':
        """Merge words/segments shorter than ``min_dur`` with neighbors.

        Same back-to-front scan as Segment.apply_min_dur: edge segments merge
        inward, interior ones toward the currently-shorter neighbor.
        """
        result = self if inplace else deepcopy(self)
        last = len(result.segments) - 1
        if last == 0:
            return result
        for i in reversed(range(len(result.segments))):
            if last == 0:
                break
            if result.segments[i].duration >= min_dur:
                continue
            if i == last:
                pair = (i - 1, i)
            elif i == 0:
                pair = (i, i + 1)
            elif result.segments[i + 1].duration < result.segments[i - 1].duration:
                pair = (i - 1, i)
            else:
                pair = (i, i + 1)
            result.add_segments(*pair, inplace=True, reassign_ids=False)
            last -= 1
        result.reassign_ids()
        for s in result.segments:
            s.apply_min_dur(min_dur, inplace=True)
        return result

    def suppress_silence(self, silent_starts: np.ndarray,
                         silent_ends: np.ndarray,
                         min_word_dur: Optional[float] = None,
                         word_level: bool = True,
                         nonspeech_error: float = 0.3,
                         use_word_position: bool = True,
                         verbose: bool = True) -> 'WhisperResult':
        """Snap start/end timestamps off the given silent sections."""
        min_word_dur = get_min_word_dur(min_word_dur)
        for seg in self.segments:
            seg.suppress_silence(silent_starts, silent_ends, min_word_dur,
                                 word_level=word_level,
                                 nonspeech_error=nonspeech_error,
                                 use_word_position=use_word_position)
        return self

    def _detect_silence(self, audio, vad, vad_threshold, q_levels, k_size,
                        sample_rate, verbose):
        """Silence (start, end) arrays via VAD or the loudness heuristic."""
        from ..stabilization import get_vad_silence_func
        from ..stabilization.nonvad import audio2timings
        if vad is not False:
            vad_kwargs = vad if isinstance(vad, dict) else {}
            detect = get_vad_silence_func(**vad_kwargs, verbose=verbose)
            return detect(audio, speech_threshold=vad_threshold, sr=sample_rate)
        return audio2timings(audio, q_levels=q_levels, k_size=k_size,
                             sr=sample_rate)

    def adjust_by_silence(self, audio, vad: Union[bool, dict] = False, *,
                          verbose: Optional[bool] = False,
                          sample_rate: Optional[int] = None,
                          vad_onnx: bool = False, vad_threshold: float = 0.35,
                          q_levels: int = 20, k_size: int = 5,
                          min_word_dur: Optional[float] = None,
                          min_silence_dur: Optional[float] = None,
                          word_level: bool = True,
                          nonspeech_error: float = 0.3,
                          use_word_position: bool = True) -> 'WhisperResult':
        """Detect silence in ``audio`` then :meth:`suppress_silence` with it."""
        from ..stabilization.utils import filter_timings
        min_word_dur = get_min_word_dur(min_word_dur)
        silent_timings = self._detect_silence(
            audio, vad, vad_threshold, q_levels, k_size, sample_rate, verbose)
        if silent_timings is None:
            return self
        if min_silence_dur:
            silent_timings = filter_timings(silent_timings, min_silence_dur)
        self.suppress_silence(*silent_timings, min_word_dur=min_word_dur,
                              word_level=word_level,
                              nonspeech_error=nonspeech_error,
                              use_word_position=use_word_position,
                              verbose=verbose is not None)
        self.update_nonspeech_sections(*silent_timings)
        return self

    def adjust_by_result(self, other_result: 'WhisperResult',
                         min_word_dur: Optional[float] = None, verbose: bool = False):
        """Shrink word spans to their intersection with ``other_result``'s words."""
        if not (self.has_words and other_result.has_words):
            raise NotImplementedError(
                'This operation requires results with word timestamps')
        assert [w.word for w in self.all_words()] == \
               [w.word for w in other_result.all_words()], \
               'The words in [other_result] do not match the current words.'
        min_word_dur = get_min_word_dur(min_word_dur)
        for word, other in zip(self.all_words(), other_result.all_words()):
            if word.end <= other.start:
                continue
            clipped_start = max(word.start, other.start)
            clipped_end = min(word.end, other.end)
            if clipped_end - clipped_start < min_word_dur:
                continue
            report = ''
            if word.start != clipped_start:
                if verbose:
                    report += f'[Start:{word.start:.3f}->{clipped_start:.3f}] '
                word.start = clipped_start
            if word.end != clipped_end:
                if verbose:
                    report += f'[End:{word.end:.3f}->{clipped_end:.3f}]  '
                word.end = clipped_end
            if report:
                print(f'{report}"{word.word}"')

    # -- structural editing: splitting / merging -------------------------------------------

    def add_segments(self, index0: int, index1: int, inplace: bool = False,
                     lock: bool = False, newline: bool = False,
                     reassign_ids: bool = True) -> Segment:
        first = self.segments[index0]
        joined = first.add(self.segments[index1], copy_words=False,
                           newline=newline, reassign_ids=reassign_ids)
        if lock and first.has_words:
            boundary = len(first.words)  # first word index of the old 2nd seg
            joined.words[boundary - 1].lock_right()
            if boundary < len(joined.words):
                joined.words[boundary].lock_left()
        if inplace:
            keep, drop = sorted((index0, index1))
            self.segments[keep] = joined
            del self.segments[drop]
            if reassign_ids:
                self.reassign_ids(True)
        return joined

    def split_segment_by_index(self, segment: Union[int, Segment],
                               indices: Union[int, List[int]],
                               reassign_ids: bool = True):
        if not self.has_words:
            return
        if isinstance(indices, int):
            indices = [indices]
        elif not indices:
            return
        out_of_range = [i for i in indices if not 0 <= i <= len(segment.words)]
        if out_of_range:
            raise IndexError(f'got out of split range indices: {out_of_range}')
        seg_idx = segment if isinstance(segment, int) else segment.id
        pieces = self.segments[seg_idx].split(indices, reassign_ids=reassign_ids)
        self.segments[seg_idx:seg_idx + 1] = pieces
        if reassign_ids:
            self.reassign_ids(True)

    def _remove_special_period_indices(self, indices: List[int], segment_idx: int):
        """Drop split indices landing on abbreviation-like periods in place."""
        segment = self.segments[segment_idx]
        for pos in reversed(range(len(indices))):
            text = segment[indices[pos]].word
            if not text.endswith('.'):
                continue
            text = text.strip()
            if (_SPECIAL_PERIOD_START.search(text)
                    and len(_SPECIAL_PERIOD_STRIP.sub('', text)) < 3):
                indices.pop(pos)

    def _split_segments(self, get_indices, args: Optional[list] = None, *,
                        lock: bool = False, newline: bool = False,
                        ignore_special_periods: bool = False):
        saw_wordless = False
        for i in reversed(range(len(self.segments))):
            seg = self.segments[i]
            saw_wordless = saw_wordless or not seg.has_words
            indices = sorted(set(get_indices(seg, *(args or []))))
            if ignore_special_periods:
                self._remove_special_period_indices(indices, i)
            if not indices:
                continue
            if newline:
                self._newline_at(seg, indices, lock)
            else:
                pieces = seg.split(indices, reassign_ids=False)
                if lock:
                    self._lock_split_edges(pieces)
                self.segments[i:i + 1] = pieces
        if saw_wordless:
            warnings.warn('Found segment(s) without word timings. '
                          'These segment(s) cannot be split.')
        self.remove_no_word_segments()

    @staticmethod
    def _newline_at(seg: Segment, indices: List[int], lock: bool):
        """Append '\\n' to the words at ``indices`` instead of splitting."""
        if indices[-1] == len(seg.words) - 1:
            indices.pop()
        for word_idx in indices:
            word = seg.words[word_idx]
            if word.word.endswith('\n'):
                continue
            word.word += '\n'
            if lock:
                word.lock_right()
                if word_idx + 1 < len(seg.words):
                    seg.words[word_idx + 1].lock_left()

    @staticmethod
    def _lock_split_edges(pieces: List[Segment]):
        """Lock the freshly-cut boundaries so later ops won't undo the split."""
        for piece in pieces:
            if piece is not pieces[0]:
                piece.lock_left()
            if piece is not pieces[-1]:
                piece.lock_right()

    def _merge_segments(self, indices: List[int], *,
                        max_words: Optional[int] = None,
                        max_chars: Optional[int] = None,
                        is_sum_max: bool = False,
                        lock: bool = False, newline: bool = False):
        def too_big(a: int, b: int, cap: int) -> bool:
            return (a + b > cap) if is_sum_max else (a > cap and b > cap)

        for i in reversed(indices):
            seg, nxt = self.segments[i], self.segments[i + 1]
            if (max_words and seg.has_words
                    and too_big(seg.word_count(), nxt.word_count(), max_words)):
                continue
            if max_chars and too_big(seg.char_count(), nxt.char_count(), max_chars):
                continue
            self.add_segments(i, i + 1, inplace=True, lock=lock, newline=newline,
                              reassign_ids=False)
        if indices:
            self.remove_no_word_segments()

    # -- regroup operations (DSL-visible; signatures define positional DSL args) ----------

    def ignore_special_periods(self, enable: bool = True) -> 'WhisperResult':
        """Default all ``ignore_special_periods`` options to ``enable``."""
        self._ignore_special_periods = enable
        self._update_history(f'isp={int(enable)}')
        return self

    def split_by_gap(self, max_gap: float = 0.1, lock: bool = False,
                     newline: bool = False,
                     ignore_special_periods: bool = False) -> 'WhisperResult':
        """Split segments at word gaps greater than ``max_gap`` seconds."""
        ignore_special_periods = self._ignore_special_periods or ignore_special_periods
        self._split_segments(lambda x: x.get_gap_indices(max_gap), lock=lock,
                             newline=newline,
                             ignore_special_periods=ignore_special_periods)
        self._update_history(
            f'sg={max_gap}+{int(lock)}+{int(newline)}+{int(ignore_special_periods)}')
        return self

    def merge_by_gap(self, min_gap: float = 0.1, max_words: Optional[int] = None,
                     max_chars: Optional[int] = None, is_sum_max: bool = False,
                     lock: bool = False, newline: bool = False) -> 'WhisperResult':
        """Merge adjacent segments whose gap is at most ``min_gap`` seconds."""
        self._merge_segments(self.get_gap_indices(min_gap),
                             max_words=max_words, max_chars=max_chars,
                             is_sum_max=is_sum_max, lock=lock, newline=newline)
        self._update_history(
            f'mg={min_gap}+{max_words or ""}+{max_chars or ""}'
            f'+{int(is_sum_max)}+{int(lock)}+{int(newline)}')
        return self

    @staticmethod
    def _punct_to_str(punctuation) -> str:
        return '/'.join(p if isinstance(p, str) else '*'.join(p)
                        for p in punctuation)

    def split_by_punctuation(self, punctuation, lock: bool = False,
                             newline: bool = False,
                             min_words: Optional[int] = None,
                             min_chars: Optional[int] = None,
                             min_dur: Optional[float] = None,
                             ignore_special_periods: bool = False) -> 'WhisperResult':
        """Split segments at words that start/end with ``punctuation``."""
        if any((min_words, min_chars, min_dur)):
            eligible = {
                s.id for s in self.segments
                if (min_words and len(s.words) >= min_words)
                or (min_chars and s.char_count() >= min_chars)
                or (min_dur and s.duration >= min_dur)}
        else:
            eligible = None

        def get_indices(seg: Segment):
            if eligible is not None and seg.id not in eligible:
                return []
            return seg.get_punctuation_indices(punctuation)

        ignore_special_periods = self._ignore_special_periods or ignore_special_periods
        self._split_segments(get_indices, lock=lock, newline=newline,
                             ignore_special_periods=ignore_special_periods)
        self._update_history(
            f'sp={self._punct_to_str(punctuation)}+{int(lock)}+{int(newline)}'
            f'+{min_words or ""}+{min_chars or ""}+{min_dur or ""}'
            f'+{int(ignore_special_periods)}')
        return self

    def merge_by_punctuation(self, punctuation, max_words: Optional[int] = None,
                             max_chars: Optional[int] = None, is_sum_max: bool = False,
                             lock: bool = False, newline: bool = False) -> 'WhisperResult':
        """Merge adjacent segments joined by ``punctuation``."""
        self._merge_segments(self.get_punctuation_indices(punctuation),
                             max_words=max_words, max_chars=max_chars,
                             is_sum_max=is_sum_max, lock=lock, newline=newline)
        self._update_history(
            f'mp={self._punct_to_str(punctuation)}+{max_words or ""}'
            f'+{max_chars or ""}+{int(is_sum_max)}+{int(lock)}+{int(newline)}')
        return self

    def merge_all_segments(self, record: bool = True) -> 'WhisperResult':
        """Collapse every segment into one."""
        if not self.segments:
            return self
        if self.has_words:
            merged = self.segments[0].copy(self.all_words(), keep_result=True,
                                           copy_words=False)
        else:
            merged = self.segments[0]
            merged._plain['text'] = self.text
            if all(s.tokens is not None for s in self.segments):
                merged._plain['tokens'] = [t for s in self.segments
                                           for t in s.tokens]
            merged.end = self.segments[-1].end
        self.segments = [merged]
        self.reassign_ids()
        if record:
            self._update_history('ms')
        return self

    def split_by_length(self, max_chars: Optional[int] = None,
                        max_words: Optional[int] = None, even_split: bool = True,
                        force_len: bool = False, lock: bool = False,
                        include_lock: bool = False, newline: bool = False,
                        ignore_special_periods: bool = False) -> 'WhisperResult':
        """Split segments exceeding ``max_chars``/``max_words``."""
        if force_len:
            self.merge_all_segments(record=False)
        ignore_special_periods = self._ignore_special_periods or ignore_special_periods
        self._split_segments(
            lambda x: x.get_length_indices(
                max_chars=max_chars, max_words=max_words,
                even_split=even_split, include_lock=include_lock),
            lock=lock, newline=newline,
            ignore_special_periods=ignore_special_periods)
        self._update_history(
            f'sl={max_chars or ""}+{max_words or ""}+{int(even_split)}+{int(force_len)}'
            f'+{int(lock)}+{int(include_lock)}+{int(newline)}+{int(ignore_special_periods)}')
        return self

    def split_by_duration(self, max_dur: float, even_split: bool = True,
                          force_len: bool = False, lock: bool = False,
                          include_lock: bool = False, newline: bool = False,
                          ignore_special_periods: bool = False) -> 'WhisperResult':
        """Split segments exceeding ``max_dur`` seconds."""
        if force_len:
            self.merge_all_segments(record=False)
        ignore_special_periods = self._ignore_special_periods or ignore_special_periods
        self._split_segments(
            lambda x: x.get_duration_indices(
                max_dur=max_dur, even_split=even_split, include_lock=include_lock),
            lock=lock, newline=newline,
            ignore_special_periods=ignore_special_periods)
        self._update_history(
            f'sd={max_dur}+{int(even_split)}+{int(force_len)}'
            f'+{int(lock)}+{int(include_lock)}+{int(newline)}+{int(ignore_special_periods)}')
        return self

    def clamp_max(self, medium_factor: float = 2.5, max_dur: Optional[float] = None,
                  clip_start: Optional[bool] = None,
                  verbose: bool = False) -> 'WhisperResult':
        """Clamp word durations above ``medium_factor`` * per-segment median or ``max_dur``."""
        if not (medium_factor or max_dur):
            raise ValueError('At least one of ``medium_factor``/``max_dur`` must be non-zero')
        if not self.has_words:
            warnings.warn('Cannot clamp due to missing/no word-timestamps')
            return self
        for seg in self.segments:
            cap = self._duration_cap(seg, medium_factor, max_dur)
            if not cap:
                continue
            if clip_start is None:
                # only touch the segment edges, pulling them inward
                seg.words[0].clamp_max(cap, clip_start=True, verbose=verbose)
                seg.words[-1].clamp_max(cap, clip_start=False, verbose=verbose)
            else:
                for word in seg.words:
                    word.clamp_max(cap, clip_start=clip_start, verbose=verbose)
        self._update_history(
            f'cm={medium_factor}+{max_dur or ""}+{clip_start or ""}+{int(verbose)}')
        return self

    @staticmethod
    def _duration_cap(seg: Segment, medium_factor, max_dur) -> Optional[float]:
        """The effective per-word duration limit for one segment."""
        cap = None
        if medium_factor and len(seg.words) > 1:
            durations = np.sort([w.duration for w in seg.words])
            cap = medium_factor * durations[len(durations) // 2]
        if max_dur and (not cap or cap > max_dur):
            cap = max_dur
        return cap

    def lock(self, startswith: Union[str, List[str], None] = None,
             endswith: Union[str, List[str], None] = None,
             right: bool = True, left: bool = False,
             case_sensitive: bool = False, strip: bool = True) -> 'WhisperResult':
        """Lock words/segments matching prefixes/suffixes against splits/merges."""
        assert startswith is not None or endswith is not None, \
            'Must specify [startswith] or/and [endswith].'

        def as_terms(value):
            if value is None:
                return []
            terms = [value] if isinstance(value, str) else value
            if not case_sensitive:
                terms = [t.lower() for t in terms]
            return [t.strip() for t in terms] if strip else terms

        prefixes, suffixes = as_terms(startswith), as_terms(endswith)
        for part in self.all_words_or_segments():
            text = part.word if hasattr(part, 'word') else part.text
            if not case_sensitive:
                text = text.lower()
            if strip:
                text = text.strip()
            matched = (any(text.startswith(p) for p in prefixes)
                       or any(text.endswith(s) for s in suffixes))
            if matched:
                if right:
                    part.lock_right()
                if left:
                    part.lock_left()
        self._update_history(
            f'l={"/".join(prefixes)}+{"/".join(suffixes)}'
            f'+{int(right)}+{int(left)}+{int(case_sensitive)}+{int(strip)}')
        return self

    def unlock_all_segments(self) -> 'WhisperResult':
        for s in self.segments:
            s.unlock_all_words()
        return self

    def pad(self, start_pad: Optional[float] = None, end_pad: Optional[float] = None,
            max_dur: Optional[float] = None, max_end: Optional[float] = None,
            word_level: bool = False) -> 'WhisperResult':
        """Extend start/end timestamps without crossing neighbors or ``max_end``."""
        if not (start_pad or end_pad):
            warnings.warn('No ``start_pad`` or ``end_pad`` given.', stacklevel=2)
            return self
        assert not start_pad or start_pad > 0, '``start_pad`` must be positive'
        assert not end_pad or end_pad > 0, '``end_pad`` must be positive'
        assert max_dur is None or max_dur > 0, '``max_dur`` must be greater than 0'
        assert max_end is None or max_end > 0, '``max_end`` must be greater than 0'
        if word_level and not self.has_words:
            word_level = False
        parts = self.all_words() if word_level else self.segments
        for i, part in enumerate(parts):
            if max_dur and part.end - part.start > max_dur:
                continue
            if start_pad:
                prev_end = parts[i - 1].end if i else 0
                part.start = max(prev_end, part.start - start_pad)
            if end_pad:
                stretched = part.end + end_pad
                cap = max_end
                if i + 1 < len(parts):
                    nxt = parts[i + 1].start
                    cap = min(max_end, nxt) if max_end else nxt
                if cap and cap < stretched:
                    stretched = cap
                if stretched > part.end:
                    part.end = stretched
        self._update_history(
            f'p={start_pad or ""}+{end_pad or ""}+{max_dur or ""}'
            f'+{max_end or ""}+{int(word_level)}')
        return self

    # -- content removal / repair --------------------------------------------------------

    def _verify_membership(self, obj, lookup, kind: str):
        """Ensure ``obj`` is still at the id it claims; re-id once if stale."""
        if lookup() is not obj:
            self.reassign_ids()
            if lookup() is not obj:
                raise ValueError(f'{kind} not in result')

    def remove_word(self, word: Union[WordTiming, Tuple[int, int]],
                    reassign_ids: bool = True, verbose: bool = True,
                    record: bool = True) -> 'WhisperResult':
        """Remove a word by instance or (segment index, word index)."""
        if isinstance(word, WordTiming):
            self._verify_membership(word, lambda: self[word.segment_id][word.id],
                                    'word')
            seg_id, word_id = word.segment_id, word.id
        elif isinstance(word, str):
            seg_id, word_id = map(int, word.split(','))
        else:
            seg_id, word_id = word
        if verbose:
            print(f'Removed: {self[seg_id][word_id].to_dict()}')
        del self.segments[seg_id].words[word_id]
        if not reassign_ids:
            return self
        if self[seg_id].has_words:
            self[seg_id].reassign_ids()
        else:
            self.remove_no_word_segments()
        if record:
            self._update_history(f'rw={seg_id},{word_id}+{int(reassign_ids)}+{int(verbose)}')
        return self

    def remove_segment(self, segment: Union[Segment, int], reassign_ids: bool = True,
                       verbose: bool = True, record: bool = True) -> 'WhisperResult':
        """Remove a segment by instance or index."""
        if isinstance(segment, Segment):
            self._verify_membership(segment, lambda: self[segment.id], 'segment')
            segment = segment.id
        if verbose:
            print(f'Removed: [id:{self[segment].id}] {self[segment].to_display_str(True)}')
        del self.segments[segment]
        if not reassign_ids:
            return self
        self.reassign_ids(True, start=segment)
        if record:
            self._update_history(f'rs={segment}+{int(reassign_ids)}+{int(verbose)}')
        return self

    def remove_repetition(self, max_words: int = 1, case_sensitive: bool = False,
                          strip: bool = True, ignore_punctuations: str = "\"',.?!",
                          extend_duration: bool = True,
                          verbose: bool = True) -> 'WhisperResult':
        """Collapse consecutively repeating runs of up to ``max_words`` words.

        For each run length, scans back-to-front comparing adjacent
        ``count``-word windows on normalized text; on a repeat, the second
        window is deleted and each survivor keeps the longer-text twin.
        """
        if not self.has_words:
            return self
        for count in range(1, max_words + 1):
            all_words = self.all_words()
            if len(all_words) < 2:
                return self
            keys = _normalize_tokens([w.word for w in all_words],
                                     case_sensitive, strip, ignore_punctuations)
            resume_at = None  # next window end after a deletion
            changes = []
            for i in reversed(range(count * 2, len(keys) + 1)):
                if resume_at is not None:
                    if resume_at != i:
                        continue
                    resume_at = None
                mid = i - count
                if keys[mid - count:mid] != keys[mid:i]:
                    continue
                resume_at = mid
                if extend_duration:
                    all_words[mid - 1].end = all_words[i - 1].end
                removed_lines = []
                for j in reversed(range(mid, i)):
                    if verbose:
                        removed_lines.append(f'- {all_words[j].to_dict()}')
                    self.remove_word(all_words[j], False, verbose=False,
                                     record=False)
                if removed_lines:
                    span = (f'[{format_timestamp(all_words[mid].start)} -> '
                            f'{format_timestamp(all_words[i - 1].end)}]')
                    run_text = ''.join(w.word for w in all_words[mid:i])
                    changes.append(f'Remove: {span} {run_text}\n'
                                   + '\n'.join(reversed(removed_lines)) + '\n')
                # keep the longer-text twin of each removed word
                for kept_i, gone_i in zip(range(mid - count, mid), range(mid, i)):
                    kept, gone = all_words[kept_i], all_words[gone_i]
                    if len(kept.word) < len(gone.word):
                        gone.start, gone.end = kept.start, kept.end
                        self.segments[kept.segment_id].words[kept.id] = gone
            if changes:
                print('\n'.join(reversed(changes)))
            self.remove_no_word_segments(reassign_ids=False)
        self.reassign_ids()
        self._update_history(
            f'rp={max_words}+{int(case_sensitive)}+{int(strip)}'
            f'+{ignore_punctuations}+{int(extend_duration)}+{int(verbose)}')
        return self

    def remove_words_by_str(self, words: Union[str, List[str], None],
                            case_sensitive: bool = False, strip: bool = True,
                            ignore_punctuations: str = "\"',.?!",
                            min_prob: Optional[float] = None,
                            filters: Optional[Callable] = None,
                            verbose: bool = True) -> 'WhisperResult':
        """Remove words matching ``words`` (optionally gated by probability/filter)."""
        if not self.has_words:
            return self
        if isinstance(words, str):
            words = [words]
        elif words == 0:
            words = None
        filters = self._content_cache.resolve(filters)
        all_words = self.all_words()
        keys = _normalize_tokens([w.word for w in all_words],
                                 case_sensitive, strip, ignore_punctuations)
        if words is not None:
            words = _normalize_tokens(words, case_sensitive, strip,
                                      ignore_punctuations)
        changes = []
        for i in reversed(range(len(keys))):
            if words is not None and keys[i] not in words:
                continue
            target = all_words[i]
            below_prob = (min_prob is None or target.probability is None
                          or min_prob > target.probability)
            if below_prob and (filters is None or filters(target)):
                if verbose:
                    changes.append(f'Removed: {target.to_dict()}')
                self.remove_word(target, False, verbose=False, record=False)
        if changes:
            print('\n'.join(reversed(changes)))
        self.remove_no_word_segments()
        self._update_history(
            f'rws={0 if words is None else "/".join(words)}'
            f'+{int(case_sensitive)}+{int(strip)}'
            f'+{ignore_punctuations}+{min_prob}'
            f'+{self._content_cache.store(filters)}+{int(verbose)}')
        return self

    def fill_in_gaps(self, other_result: Union['WhisperResult', str],
                     min_gap: float = 0.1, case_sensitive: bool = False,
                     strip: bool = True, ignore_punctuations: str = "\"',.?!",
                     verbose: bool = True) -> 'WhisperResult':
        """Fill gaps larger than ``min_gap`` with overlapping content from another result."""
        if len(self.segments) < 2:
            return self
        other_result = self._content_cache.resolve(other_result)
        if isinstance(other_result, str):
            other_path = other_result
            other_result = WhisperResult(other_result)
        else:
            other_path = self._content_cache.store(other_result)

        def norm(text: str) -> str:
            return _normalize_tokens([text], case_sensitive, strip,
                                     ignore_punctuations)[0]

        # boundary list: (insertion index, segment before, segment after),
        # with virtual open boundaries at both ends of the result
        boundaries = [(-1, None, self.segments[0])]
        boundaries += [(i, a, b) for i, (a, b) in
                       enumerate(zip(self.segments[:-1], self.segments[1:]))]
        boundaries.append((len(self.segments) - 1, self.segments[-1], None))

        changes = []
        for i, seg0, seg1 in reversed(boundaries):
            left_word = seg0.words[-1] if seg0 is not None else None
            right_word = seg1.words[0] if seg1 is not None else None
            start = other_result[0].start if left_word is None else left_word.end
            end = other_result[-1].end if right_word is None else right_word.start
            if end - start <= min_gap:
                continue
            gap_words = other_result.get_content_by_time((start, end))
            # duplicated edge words extend the existing boundary words instead
            if left_word is not None and gap_words and \
                    norm(left_word.word) == norm(gap_words[0].word):
                left_word.end = gap_words[0].end
                gap_words = gap_words[1:]
            if right_word is not None and gap_words and \
                    norm(right_word.word) == norm(gap_words[-1].word):
                right_word.start = gap_words[-1].start
                gap_words = gap_words[:-1]
            if not gap_words:
                continue
            if right_word is not None and right_word.start < gap_words[-1].end:
                right_word.start = gap_words[-1].end
            inserted = [other_result[gap_words[0].segment_id].copy([])]
            for j, gap_word in enumerate(gap_words):
                word_copy = gap_word.copy(copy_tokens=True)
                if j == 0 and left_word is not None and left_word.end > gap_word.start:
                    word_copy.start = left_word.end
                if inserted[-1].id != gap_word.segment_id:
                    inserted.append(other_result[gap_word.segment_id].copy([]))
                inserted[-1].words.append(word_copy)
            if verbose:
                changes.append('\n'.join('Added: ' + s.to_display_str(True)
                                         for s in inserted))
            self.segments[i + 1:i + 1] = inserted
        if changes:
            print('\n'.join(reversed(changes)))
        self.reassign_ids()
        self._update_history(
            f'fg={other_path}+{min_gap}+{int(case_sensitive)}+{int(strip)}'
            f'+{ignore_punctuations}+{int(verbose)}')
        return self

    def adjust_gaps(self, duration_threshold: float = 0.75,
                    one_section: bool = False) -> 'WhisperResult':
        """Snap segment edges at gaps onto overlapping ``nonspeech_sections``."""
        if duration_threshold > 1:
            raise ValueError('``duration_threshold`` must be at most 1.0 '
                             f'but got {duration_threshold}')
        sections = self.nonspeech_sections
        scan = 0  # persistent cursor into the (sorted) nonspeech sections
        for seg_idx in range(-1, len(self.segments)):
            curr_part = None if seg_idx == -1 else self.segments[seg_idx]
            next_part = (None if curr_part is self.segments[-1]
                         else self.segments[seg_idx + 1])
            curr_span, next_span = self._gap_edge_spans(curr_part, next_part)
            if self.has_words:
                curr_part = curr_part[-1] if curr_part is not None else None
                next_part = next_part[0] if next_part is not None else None
            curr_start, curr_end = curr_span
            next_start, next_end = next_span

            # collect nonspeech sections falling inside this gap
            candidates: List[Tuple[float, float]] = []
            idx = scan
            for idx in range(scan, len(sections)):
                ns_start, ns_end = sections[idx]['start'], sections[idx]['end']
                open_left = curr_start < (ns_end if curr_part is None else ns_start)
                open_right = (ns_start if next_part is None else ns_end) < next_end
                if open_left and open_right:
                    candidates.append((ns_start, ns_end))
                if next_start < ns_start:
                    break
            scan = idx
            if not candidates:
                continue

            chosen = self._choose_sections(candidates, duration_threshold,
                                           curr_end, next_start, one_section)
            if chosen is None:
                continue
            (end_section, start_section) = chosen
            if curr_part is not None and curr_start < end_section[0]:
                curr_part.end = end_section[0]
            if next_part is not None and start_section[1] < next_end:
                next_part.start = start_section[1]
        self._update_history(f'ag={duration_threshold}+{int(one_section)}')
        return self

    def _gap_edge_spans(self, curr_part, next_part):
        """(start, end) spans of the parts flanking a gap, with synthetic
        spans for the open boundaries before the first / after the last
        segment (sized by doubled median word duration when words exist)."""
        if self.has_words:
            if curr_part is None:
                pad = np.median([w.duration for w in next_part]) * 2
                t = max(next_part.start - pad, 0)
                curr_span = (t, t)
            else:
                curr_span = (curr_part[-1].start, curr_part[-1].end)
            if next_part is None:
                pad = np.median([w.duration for w in curr_part]) * 2
                t = curr_part.end + pad
                next_span = (t, t)
            else:
                next_span = (next_part[0].start, next_part[0].end)
        else:
            if curr_part is None:
                t = max(next_part.start - next_part.duration, 0)
                curr_span = (t, t)
            else:
                curr_span = (curr_part.start, curr_part.end)
            if next_part is None:
                t = curr_part.end + curr_part.duration
                next_span = (t, t)
            else:
                next_span = (next_part.start, next_part.end)
        return curr_span, next_span

    @staticmethod
    def _choose_sections(candidates, duration_threshold, curr_end, next_start,
                         one_section):
        """Pick the nonspeech section(s) to snap the gap edges to.

        Only sections at least ``duration_threshold`` of the longest survive;
        edges snap to the nearest surviving section (or one shared section
        when forced or when independent picks would cross)."""
        cand = np.array(candidates)
        durations = cand[:, 1] - cand[:, 0]
        order = np.argsort(durations)
        long_enough = durations[order] / durations[order[-1]] >= duration_threshold
        order = order[long_enough]
        if not order.size:
            return None
        end_dist = np.abs(cand[order, 0] - curr_end)
        start_dist = np.abs(cand[order, 1] - next_start)
        if one_section:
            pick = order[np.argmin(end_dist + start_dist)]
            return tuple(cand[pick]), tuple(cand[pick])
        for_end = order[np.argmin(end_dist)]
        for_start = order[np.argmin(start_dist)]
        if for_end > for_start:  # crossing picks -> collapse to one section
            pick = order[np.argmin(end_dist + start_dist)]
            for_end = for_start = pick
        return tuple(cand[for_end]), tuple(cand[for_start])

    def convert_to_segment_level(self) -> 'WhisperResult':
        """Drop all word-level data, keeping segment text/timestamps."""
        for seg in self.segments:
            seg.convert_to_segment_level()
        self._update_history('csl')
        return self

    # -- custom operation mini rule engine ------------------------------------------------

    _CUSTOM_METHODS = ('mergeleft', 'mergeright', 'merge',
                       'lockright', 'lockleft', 'lock',
                       'splitright', 'splitleft', 'split', 'remove')

    @staticmethod
    def _co_merge_action(method: str):
        want_right = method in ('mergeright', 'merge')
        want_left = method in ('mergeleft', 'merge')

        def neighbor_pairs(result, seg_idx, word_idx=None):
            pairs = []
            if want_right and seg_idx + 1 < len(result.segments) and (
                    word_idx is None
                    or word_idx == len(result[seg_idx].words) - 1):
                pairs.append((seg_idx, seg_idx + 1))
            if want_left and seg_idx != 0 and (word_idx is None or word_idx == 0):
                pairs.append((seg_idx - 1, seg_idx))
            return pairs

        def action(result, seg_idx, word_idx=None):
            for pair in neighbor_pairs(result, seg_idx, word_idx):
                result.add_segments(*pair, inplace=True, reassign_ids=False)
        return action

    @staticmethod
    def _co_lock_action(method: str):
        do_right = method in ('lockright', 'lock')
        do_left = method in ('lockleft', 'lock')

        def action(result, seg_idx, word_idx=None):
            target = result[seg_idx] if word_idx is None else result[seg_idx][word_idx]
            if do_right:
                target.lock_right()
            if do_left:
                target.lock_left()
        return action

    @staticmethod
    def _co_split_action(method: str):
        def action(result, seg_idx, word_idx=None):
            if method == 'splitright':
                cuts = [] if word_idx == len(result[seg_idx].words) + 1 else [word_idx]
            elif method == 'splitleft':
                cuts = [] if word_idx == 0 else [word_idx - 1]
            else:
                cuts = ([word_idx - 1] if word_idx != 0 else []) + \
                       ([word_idx] if word_idx < len(result[seg_idx].words) + 1 else [])
            if not cuts:
                return
            result.split_segment_by_index(
                result[seg_idx], cuts if method == 'split' else cuts[0],
                reassign_ids=False)
        return action

    @staticmethod
    def _co_remove_action(result, seg_idx, word_idx=None):
        if word_idx is None:
            result.remove_segment(result[seg_idx], reassign_ids=False, record=False)
        else:
            result.remove_word(result[seg_idx][word_idx], reassign_ids=False,
                               record=False)

    def _co_resolve_action(self, method: str, word_level):
        if method.startswith('merge'):
            return self._co_merge_action(method)
        if method.startswith('lock'):
            return self._co_lock_action(method)
        if method.startswith('split'):
            if word_level is None:
                raise ValueError('Segment-level result is not compatible with split actions.')
            if not word_level:
                raise ValueError('``word_level=False`` is not compatible with split actions.')
            return self._co_split_action(method)
        return self._co_remove_action  # 'remove'

    @staticmethod
    def _co_value_getter(key: str):
        if key.startswith('len='):
            attr = key[4:]
            return lambda obj: len(getattr(obj, attr))
        if key == '':
            return lambda obj: obj
        return lambda obj: getattr(obj, key)

    def custom_operation(self, key: str, operator: Union[str, Callable], value,
                         method: Union[str, Callable],
                         word_level: Optional[bool] = None) -> 'WhisperResult':
        """Apply ``method`` to every word/segment where ``key <operator> value`` holds.

        See the reference docstring (result.py:2653-2717) for the mini-language:
        built-in operators ``==, >, >=, <, <=, is, in, start, end``; built-in
        methods merge/lock/split/remove with left/right variants; ``len=`` key
        prefix; ``any=``/``all=`` multi-value strings.
        """
        if self.has_words:
            if word_level is None:
                word_level = True
        elif word_level:
            raise ValueError('result is missing word timestamps and is not '
                             'compatible with ``word_level=True``')

        value = self._content_cache.resolve(value, strict=False)
        method = self._content_cache.resolve(method)
        is_builtin = isinstance(method, str)
        if is_builtin:
            if method not in self._CUSTOM_METHODS:
                raise ValueError(f"invalid method: '{method}'. "
                                 f'Valid methods: {self._CUSTOM_METHODS}')
            method_str = method
            action = self._co_resolve_action(method, word_level)
        elif callable(method):
            method_str = self._content_cache.store(method)
            action = method
        else:
            raise TypeError(f"'{type(method)}' object is not callable")

        key = key.replace(' ', '_')
        operator = self._content_cache.resolve(operator)
        if isinstance(operator, str):
            if operator not in _COMPARATORS:
                raise ValueError(f"invalid operator: '{operator}'. "
                                 f'Valid operators: {tuple(_COMPARATORS)}')
            operator_str, operator = operator, _COMPARATORS[operator]
        else:
            operator_str = self._content_cache.store(operator)

        get_value = self._co_value_getter(key)
        if isinstance(value, str) and value[:4] in ('all=', 'any='):
            check = any if value.startswith('any=') else all
            terms = [v.replace('\\,', ',')
                     for v in re.split(r'(?<!\\),', value[4:])]

            def is_satisfied(obj):
                return check(operator(get_value(obj), term) for term in terms)
        else:
            def is_satisfied(obj):
                return operator(get_value(obj), value)

        for seg_i in reversed(range(len(self.segments))):
            if word_level:
                for word_i in reversed(range(len(self.segments[seg_i].words))):
                    if is_satisfied(self[seg_i][word_i]):
                        action(self, seg_i, word_i)
            elif is_satisfied(self[seg_i]):
                action(self, seg_i, None)

        self.reassign_ids()
        if isinstance(value, bool) or not isinstance(value, (str, int, float)):
            value = f'<{value}>' if isinstance(value, bool) else self._content_cache.store(value)
        self._update_history(
            f'co={key.replace("_", " ")}+{operator_str}+{value}+{method_str}+{int(word_level)}')
        return self

    # -- regroup DSL ------------------------------------------------------------------------

    def regroup(self, regroup_algo: Union[str, bool, None] = None,
                verbose: bool = False, only_show: bool = False) -> 'WhisperResult':
        """Run a chain of regroup operations parsed from ``regroup_algo``.

        ``True``/``None`` use the default algorithm ('da'); ``False`` is a no-op.
        """
        if regroup_algo is False:
            return self
        if regroup_algo is None or regroup_algo is True:
            regroup_algo = 'da'
        for method, kwargs, display in self.parse_regroup_algo(
                regroup_algo, include_str=verbose or only_show):
            if display:
                print(display)
            if not only_show:
                method(**kwargs)
        return self

    def parse_regroup_algo(self, regroup_algo: str,
                           include_str: bool = True) -> List[Tuple[Callable, dict, str]]:
        """Parse a regroup DSL string into (bound method, kwargs, display) triples."""
        import inspect
        methods = {k: getattr(self, name) for k, name in _DSL_METHODS.items()}
        if not regroup_algo:
            return []
        calls = regroup_algo.split('_')
        if 'da' in calls:  # expand the default-algorithm macro in place
            expansion = DEFAULT_REGROUP_ALGO.split('_')
            calls = [part for c in calls
                     for part in (expansion if c == 'da' else [c])]
        operations = []
        for call in calls:
            name, _, arg_str = call.partition('=')
            if name not in methods:
                raise NotImplementedError(
                    f'{name} is not one of the available methods: {tuple(methods)}')
            args = ([str_to_valid_type(a) for a in arg_str.split('+')]
                    if arg_str else [])
            param_names = list(inspect.signature(methods[name]).parameters)
            # the reference zips args onto __code__.co_varnames, so a non-None
            # arg past the real parameter list lands on a local variable name
            # and raises TypeError at call time (result.py:3016) — mirror that
            # instead of silently dropping it
            for extra in args[len(param_names):]:
                if extra is not None:
                    raise TypeError(
                        f'{methods[name].__name__}() got more positional '
                        f'values than parameters: {extra!r}')
            kwargs = {k: v for k, v in zip(param_names, args) if v is not None}
            if include_str:
                rendered = ', '.join(f'{k}="{v}"' if isinstance(v, str) else f'{k}={v}'
                                     for k, v in kwargs.items())
                display = f'{methods[name].__name__}({rendered})'
            else:
                display = None
            operations.append((methods[name], kwargs, display))
        return operations

    def show_regroup_history(self):
        if not self._regroup_history:
            print('Result has no history.')
        for *_, display in self.parse_regroup_algo(self._regroup_history):
            print(f'.{display}')

    # -- search --------------------------------------------------------------------------

    def find(self, pattern: str, word_level: bool = True, flags=None):
        """Regex search over the (word- or segment-level) text with timestamps."""
        from .find import WhisperResultMatches
        return WhisperResultMatches(self).find(pattern, word_level=word_level, flags=flags)

    # -- persistence ------------------------------------------------------------------------

    def to_dict(self, keep_orig: bool = True) -> dict:
        return dict(text=self.text,
                    segments=self.segments_to_dicts(),
                    language=self.language,
                    ori_dict=self.ori_dict if keep_orig else {},
                    regroup_history=self._regroup_history,
                    nonspeech_sections=self._nonspeech_sections,
                    unfinished=self.unfinished_start)

    def segments_to_dicts(self, reverse_text: Union[bool, tuple] = False) -> List[dict]:
        if reverse_text:
            # deprecated upstream too, but still honored for RTL rendering
            # (reference result.py:609-636)
            warnings.warn('``reverse_text=True`` is deprecated. RTL playback '
                          'issues are usually caused by the player '
                          'mis-parsing word-level tags.',
                          DeprecationWarning, stacklevel=2)
        return [s.to_dict(reverse_text=reverse_text) for s in self.segments]

    def update_all_segs_with_words(self):
        # deprecated shim (reference result.py:1058-1063)
        warnings.warn('Segment attributes are word-derived properties; '
                      '``update_all_segs_with_words()`` is deprecated. Use '
                      '``.reassign_ids()`` to update ids.', stacklevel=2)
        self.reassign_ids()

    def set_current_as_orig(self, keep_orig: bool = False):
        """Overwrite ``ori_dict`` with the current state."""
        self.ori_dict = self.to_dict(keep_orig=keep_orig)

    def reset(self):
        """Restore the state captured in ``ori_dict`` (drops regroup history)."""
        self.language = self.ori_dict.get('language')
        self._regroup_history = ''
        self._materialize(self.ori_dict.get('segments'))

    # Output-format methods.
    to_srt_vtt = result_to_srt_vtt
    to_ass = result_to_ass
    to_tsv = result_to_tsv
    to_txt = result_to_txt
    save_as_json = save_as_json
