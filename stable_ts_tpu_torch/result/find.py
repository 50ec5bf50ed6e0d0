"""Regex search over results with timestamp-mapped matches.

Behavioral counterpart of ``SegmentMatch`` / ``WhisperResultMatches``
(stable-ts stable_whisper/result.py:3105-3256): searches the
concatenated transcript text and maps each regex hit back to the segments
and words whose characters it covers, so every textual match carries
timestamps.

Design notes (TPU build): the per-character bookkeeping is factored into a
``_searchable`` table builder (text + one (segment, word) origin entry per
character) rather than being interleaved with the regex loop.
"""
import re
import warnings
from typing import List, Optional, Tuple, Union

from .segment import Segment
from .whisper_result import WhisperResult


class SegmentMatch:
    """One regex hit: the segments/words it covers plus the matched text."""

    def __init__(self, segments: Union[List[Segment], Segment],
                 _word_indices: Optional[List[List[int]]] = None,
                 _text_match: Optional[str] = None):
        self.segments = [segments] if isinstance(segments, Segment) else segments
        self.word_indices = _word_indices or []
        self.words = [seg.words[j]
                      for seg, indices in zip(self.segments, self.word_indices)
                      for j in indices]
        source = self.words if self.words else self.segments
        self.text = ''.join(part.word if self.words else part.text
                            for part in source)
        self.text_match = _text_match

    @property
    def start(self):
        for part in (self.words, self.segments):
            if part:
                return part[0].start
        return None

    @property
    def end(self):
        for part in (self.words, self.segments):
            if part:
                return part[-1].end
        return None

    def __len__(self):
        return len(self.segments)

    def __repr__(self):
        return repr(vars(self))

    def __str__(self):
        return str(vars(self))


def _searchable(run: List[Tuple[int, Segment]], word_level: bool):
    """Concatenated text of a segment run + per-character origin table.

    Each character of the returned text is annotated with the
    ``(segment index, word index)`` it came from (word index None at
    segment level), so a regex span maps directly back to sources.
    """
    chars: List[str] = []
    origin: List[Tuple[int, Optional[int]]] = []
    for seg_idx, seg in run:
        if word_level:
            for word_idx, word in enumerate(seg.words):
                chars.append(word.word)
                origin.extend([(seg_idx, word_idx)] * len(word.word))
        else:
            chars.append(seg.text)
            origin.extend([(seg_idx, None)] * len(seg.text))
    text = ''.join(chars)
    assert len(origin) == len(text)
    return text, origin


class WhisperResultMatches:
    """A set of matches; ``find`` chains, narrowing to previous match spans."""

    def __init__(self, matches: Union[List[SegmentMatch], WhisperResult],
                 _segment_indices: Optional[List[List[int]]] = None):
        if isinstance(matches, WhisperResult):
            self.matches = [SegmentMatch(seg) for seg in matches.segments]
            self._segment_indices = [[i] for i in range(len(matches.segments))]
        else:
            assert _segment_indices is not None
            assert len(matches) == len(_segment_indices)
            assert all(len(m.segments) == len(idxs)
                       for m, idxs in zip(matches, _segment_indices))
            self.matches = matches
            self._segment_indices = _segment_indices

    @property
    def segment_indices(self):
        return self._segment_indices

    def _curr_seg_groups(self) -> List[List[Tuple[int, Segment]]]:
        """Deduplicate the matched segments and bucket them into runs.

        Segments are taken in ascending original order (duplicates across
        overlapping matches dropped). A run closes right after the element
        that *breaks* consecutiveness — i.e. the first segment after a gap
        lands at the end of the previous run — matching the reference's
        grouping exactly (result.py:3175-3189).
        """
        ordered: List[Tuple[int, Segment]] = []
        top = -1
        for indices, match in zip(self._segment_indices, self.matches):
            for idx, seg in zip(sorted(indices), match.segments):
                if idx > top:
                    ordered.append((idx, seg))
                    top = idx
        runs: List[List[Tuple[int, Segment]]] = []
        current: List[Tuple[int, Segment]] = []
        prev_idx = -1
        for idx, seg in ordered:
            current.append((idx, seg))
            if idx - prev_idx != 1:
                runs.append(current)
                current = []
            prev_idx = idx
        if current:
            runs.append(current)
        return runs

    def find(self, pattern: str, word_level: bool = True, flags=None) -> 'WhisperResultMatches':
        """Regex-search the (current) matched spans; returns chained matches."""
        if word_level and any(not seg.has_words
                              for match in self.matches
                              for seg in match.segments):
            warnings.warn('Cannot perform word-level search with segment(s) '
                          'missing word timestamps.')
            word_level = False

        hits: List[SegmentMatch] = []
        hit_seg_indices: List[List[int]] = []
        for run in self._curr_seg_groups():
            text, origin = _searchable(run, word_level)
            by_index = dict(run)
            for found in re.finditer(pattern, text, flags=flags or 0):
                span_origin = origin[slice(*found.span())]
                seg_indices = sorted({si for si, _ in span_origin})
                if word_level:
                    word_indices = [sorted({wi for si, wi in span_origin
                                            if si == target})
                                    for target in seg_indices]
                else:
                    word_indices = None
                hits.append(SegmentMatch(
                    segments=[by_index[si] for si in seg_indices],
                    _word_indices=word_indices,
                    _text_match=found.group()))
                hit_seg_indices.append(seg_indices)
        return WhisperResultMatches(hits, hit_seg_indices)

    def __len__(self):
        return len(self.matches)

    def __bool__(self):
        return bool(self.matches)

    def __getitem__(self, idx):
        return self.matches[idx]
