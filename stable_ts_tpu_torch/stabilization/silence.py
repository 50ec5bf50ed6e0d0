"""Timestamp clipping against detected silence.

This is the core "stabilization" rule: move a word's (or segment's) start/end
timestamps off silent audio. Behavior matches the reference's
``suppress_silence`` (stable-ts stable_whisper/stabilization/__init__.py:300-379):

1. If the object's *start* falls inside a silent section that ends within the
   object, snap the start forward to the silence's end (when ``keep_end`` is
   True or None).
2. If the object's *end* falls inside a silent section that starts within the
   object, snap the end back to the silence's start (when ``keep_end`` is False).
3. If exactly one silent section lies strictly inside the object, and the
   speech overhang on either side is within ``nonspeech_error`` (relative to
   the silence duration), shrink the object to exclude the silence — keeping
   whichever edge ``keep_end`` dictates (None picks the side with less error).

All adjustments preserve at least ``min_word_dur`` of duration.
"""
from typing import List, Optional, Union

import numpy as np


def suppress_silence(
        obj,
        silent_starts: Union[np.ndarray, List[float]],
        silent_ends: Union[np.ndarray, List[float]],
        min_word_dur: float,
        nonspeech_error: float = 0.1,
        keep_end: Optional[bool] = True,
):
    """Clip ``obj.start`` / ``obj.end`` (any object with those attributes)."""
    assert len(silent_starts) == len(silent_ends)
    if len(silent_starts) == 0 or (obj.end - obj.start) <= min_word_dur:
        return
    silent_starts = np.asarray(silent_starts, dtype=np.float64)
    silent_ends = np.asarray(silent_ends, dtype=np.float64)

    if keep_end is None or keep_end:
        # Silent sections covering the start but ending inside the object.
        covers_start = (
            (silent_starts <= obj.start)
            & (obj.start < silent_ends)
            & (silent_ends <= obj.end)
        )
        hit = np.flatnonzero(covers_start)
        if hit.size:
            new_start = silent_ends[hit[0]]
            obj.start = min(new_start, round(obj.end - min_word_dur, 3))
            if (obj.end - obj.start) <= min_word_dur:
                return

    if not keep_end:
        # Silent sections covering the end but starting inside the object.
        # NOTE: fires for keep_end=None too — with no position preference,
        # BOTH boundary clips are active (reference stabilization
        # __init__.py:317-327 gates this on ``not keep_end``).
        covers_end = (
            (obj.start <= silent_starts)
            & (silent_starts < obj.end)
            & (obj.end <= silent_ends)
        )
        hit = np.flatnonzero(covers_end)
        if hit.size:
            new_end = silent_starts[hit[0]]
            obj.end = max(new_end, round(obj.start + min_word_dur, 3))
            if (obj.end - obj.start) <= min_word_dur:
                return

    if not nonspeech_error:
        return

    # Silent sections fully inside the object.
    inside = np.flatnonzero((obj.start <= silent_starts) & (obj.end >= silent_ends))
    if inside.size != 1:
        # Ambiguous (multiple inner silences) or none: leave untouched,
        # matching the reference's single-match requirement (:341-342).
        return
    matches = inside.tolist()

    def relative_errors(sil_start: float, sil_end: float):
        sil_dur = sil_end - sil_start
        start_err = (sil_start - obj.start) / sil_dur
        end_err = (obj.end - sil_end) / sil_dur
        return start_err, end_err

    def try_adjust(sil_start: float, sil_end: float, errors=None):
        if not errors:
            errors = relative_errors(sil_start, sil_end)
        edge_keep_end = keep_end
        if edge_keep_end is None:
            edge_keep_end = errors[0] <= errors[1]
        if not (errors[0] <= nonspeech_error or errors[1] <= nonspeech_error):
            return
        if edge_keep_end:
            obj.start = min(sil_end, round(obj.end - min_word_dur, 3))
        else:
            obj.end = max(sil_start, round(obj.start + min_word_dur, 3))

    last = len(matches) - 1
    for i in range(len(matches)):
        errors = None
        if i == last:
            pick = 0
        elif keep_end is None:
            err_first = relative_errors(silent_starts[matches[0]], silent_ends[matches[0]])
            err_last = relative_errors(silent_starts[matches[-1]], silent_ends[matches[-1]])
            pick, errors = (0, err_first) if min(err_first) <= min(err_last) else (-1, err_last)
        else:
            pick = 0 if keep_end else -1
        idx = matches.pop(pick)
        try_adjust(silent_starts[idx], silent_ends[idx], errors)
