"""Mask <-> timing conversions and ordering checks (pure NumPy).

Behavioral counterpart of stable-ts stable_whisper/stabilization/utils.py
(mask2timing:43, timing2mask:89, filter_timings:114, valid_ts:30), written
torch-free: masks are NumPy bool arrays throughout.
"""
import warnings
from itertools import chain
from typing import List, Optional, Tuple, Union

import numpy as np

from ..constants import TOKENS_PER_SECOND

TimingPair = Tuple[np.ndarray, np.ndarray]


def is_ascending_sequence(seq: List[Union[int, float]], verbose: bool = True) -> bool:
    """Whether ``seq`` is non-decreasing; optionally print offending pairs."""
    ascending = True
    for idx in range(len(seq) - 1):
        if seq[idx] > seq[idx + 1]:
            ascending = False
            if verbose:
                print(f'[Index{idx}]:{seq[idx]} > [Index{idx + 1}]:{seq[idx + 1]}')
            else:
                break
    return ascending


def valid_ts(ts: List[dict], warn: bool = True) -> bool:
    """Whether a list of {'start','end'} dicts is in ascending order."""
    flat = list(chain.from_iterable((s['start'], s['end']) for s in ts))
    ok = is_ascending_sequence(flat, verbose=False)
    if warn and not ok:
        warnings.warn('Found timestamp(s) out of order.')
    return ok


def mask2timing(
        silence_mask: Optional[np.ndarray],
        time_offset: float = 0.0,
        second_per_unit: Optional[float] = None,
        min_start: Optional[float] = None,
        max_end: Optional[float] = None,
) -> Optional[TimingPair]:
    """Convert a 1-D bool mask into (starts, ends) arrays of its True runs.

    Each unit of the mask spans ``second_per_unit`` seconds (default: one
    Whisper token = 1/TOKENS_PER_SECOND = 20 ms). Returns None when the mask
    is empty or has no True entries.
    """
    if silence_mask is None or len(silence_mask) == 0:
        return None
    silence_mask = np.asarray(silence_mask, dtype=bool)
    assert silence_mask.ndim == 1
    if not silence_mask.any():
        return None
    padded = np.concatenate(([False], silence_mask, [False]))
    rising = np.flatnonzero(~padded[:-2] & padded[1:-1])
    falling = np.flatnonzero(padded[1:-1] & ~padded[2:]) + 1
    unit = (1.0 / TOKENS_PER_SECOND) if second_per_unit is None else second_per_unit
    starts = rising * unit
    ends = falling * unit
    if time_offset:
        starts = starts + time_offset
        ends = ends + time_offset
    clipped = False
    if min_start is not None and starts[0] < min_start:
        starts = starts.clip(min_start, None)
        clipped = True
    if max_end is not None and ends[-1] > max_end:
        ends = ends.clip(None, max_end)
        clipped = True
    if clipped:
        keep = starts < ends
        if not keep.any():
            return None
        if not keep.all():
            starts, ends = starts[keep], ends[keep]
    return starts, ends


def timing2mask(
        silent_starts: np.ndarray,
        silent_ends: np.ndarray,
        size: int,
        time_offset: Optional[float] = None,
        units_per_second: Optional[int] = None,
) -> np.ndarray:
    """Rasterize (starts, ends) second-timings into a bool mask of ``size`` units.

    The end unit is inclusive (matches reference timing2mask:108-109).
    """
    if units_per_second is None:
        units_per_second = TOKENS_PER_SECOND
    assert len(silent_starts) == len(silent_ends)
    mask = np.zeros(size, dtype=bool)
    starts = np.asarray(silent_starts, dtype=np.float64)
    ends = np.asarray(silent_ends, dtype=np.float64)
    if time_offset:
        starts = (starts - time_offset).clip(min=0)
        ends = (ends - time_offset).clip(min=0)
    first = np.round(starts * units_per_second).astype(np.int64)
    last = np.round(ends * units_per_second).astype(np.int64)
    for i, j in zip(first, last):
        mask[i:j + 1] = True
    return mask


def filter_timings(
        silent_timings: Optional[TimingPair],
        min_silence_dur: float,
) -> Optional[TimingPair]:
    """Drop silent sections shorter than ``min_silence_dur`` seconds."""
    if silent_timings is None:
        return None
    starts, ends = silent_timings
    keep = (ends - starts) >= min_silence_dur
    return starts[keep], ends[keep]
