"""Repair missing (None) timestamps in untrusted backend output.

Third-party ASR backends (HF's chunked pipeline, some CTC decoders) emit
words or segments whose ``start``/``end`` is None — feeding those into
:class:`WhisperResult` crashes ``force_order`` or mis-sorts. The reference
repairs them by neighbor interpolation inside its HF backend
(stable-ts stable_whisper/whisper_word_level/hf_whisper.py:160-227
``replace_none_ts``; MLX has the sibling ``_fix_timestamps``,
mlx_whisper.py:113). Here the same rules live in the result-ingestion path
so EVERY adapter benefits (``transcribe_any``, the faster-whisper adapter,
user-supplied inference functions).

Rules (matching the reference exactly, including its truthiness quirks —
an end of 0.0 counts as missing for the lookahead caps):

- a missing ``start`` copies the previous part's ``end`` (the first part
  instead rewinds ``medium_dur`` from its own end, floored at 0)
- a missing ``end`` copies the next part's ``start``; when that is also
  missing, it extends ``medium_dur`` past its start, capped by the next
  part that has any timestamp and by the total audio duration
- ``medium_dur`` = 2 x the median duration of the fully-timestamped parts
  (2.0 s when there are none), computed once from the ORIGINAL values
"""
from typing import List, Optional

import numpy as np

__all__ = ['replace_none_ts', 'repair_result_timestamps', 'has_none_ts']


def replace_none_ts(parts: List[dict],
                    total_dur: Optional[float] = None) -> None:
    """Fill None ``start``/``end`` in ``parts`` (word or segment dicts),
    in place, by the reference's neighbor-interpolation rules."""
    if not parts:
        return
    # Both statistics are computed LAZILY at first use and then cached —
    # deliberately matching the reference, where earlier in-loop fills can
    # complete (start, end) pairs that then participate in the median, and
    # the any-timestamp mask snapshots whatever is filled by the time the
    # first extended-end cap is needed.
    cache = {}

    def has_any_ts() -> np.ndarray:
        if 'mask' not in cache:
            cache['mask'] = np.array([(p['end'] or p['start']) is not None
                                      for p in parts])
        return cache['mask']

    def medium_dur() -> float:
        if 'dur' not in cache:
            durs = np.array([p['end'] - p['start'] for p in parts
                             if p['end'] is not None
                             and p['start'] is not None])
            cache['dur'] = float(np.median(durs) * 2) if len(durs) else 2.0
        return cache['dur']

    def max_end_after(next_idx: int) -> Optional[float]:
        """Cap for an extended end: the next part carrying any timestamp
        (its start if truthy, else its end — the reference's ``or`` pick),
        else the total audio duration (None = uncapped)."""
        if next_idx != len(parts):
            later = np.flatnonzero(has_any_ts()[next_idx:])
            if len(later):
                part = parts[later[0] + next_idx]
                return part['start'] or part['end']
        return total_dur

    for i, part in enumerate(parts):
        if part['start'] is None:
            if i == 0:
                part['start'] = max(
                    round((part['end'] or 0) - medium_dur(), 3), 0.0)
            else:
                part['start'] = parts[i - 1]['end']
        if part['end'] is None:
            next_start = (parts[i + 1]['start'] if i + 1 < len(parts)
                          else None)
            if next_start is not None:
                part['end'] = next_start
            else:
                new_end = round(part['start'] + medium_dur(), 3)
                cap = max_end_after(i + 1)
                part['end'] = new_end if cap is None else min(new_end, cap)


def has_none_ts(segments: List[dict]) -> bool:
    """True if any segment (or any of its words) has a None start/end."""
    for seg in segments:
        if seg.get('start') is None or seg.get('end') is None:
            return True
        for w in seg.get('words') or ():
            if w.get('start') is None or w.get('end') is None:
                return True
    return False


def repair_result_timestamps(segments: List[dict],
                             total_dur: Optional[float] = None) -> None:
    """Repair a segments list in place before WhisperResult ingestion.

    Word timestamps repair as ONE flat list across all segments (the
    reference calls ``replace_none_ts`` on the transcription's flat word
    list) so interpolation sees true neighbors at segment boundaries;
    segment spans then re-derive from their words. Wordless segments
    repair at segment level.
    """
    words = [w for seg in segments for w in (seg.get('words') or ())]
    if words:
        replace_none_ts(words, total_dur)
        for seg in segments:
            if seg.get('words'):
                if seg.get('start') is None:
                    seg['start'] = seg['words'][0]['start']
                if seg.get('end') is None:
                    seg['end'] = seg['words'][-1]['end']
    replace_none_ts(segments, total_dur)
