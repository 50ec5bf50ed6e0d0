"""Small cross-cutting helpers.

Behavioral counterpart of the reference's ``stable_whisper/utils.py``
(console-safe printing, the regroup-DSL scalar parser, kwarg filtering,
timestamp rendering) plus the host-allocator tuning. The JAX package's
XLA compilation-cache switch has no counterpart here: the port imports no
jax.
"""
import inspect
import sys
from typing import Optional

_CONSOLE_ENCODING = sys.getdefaultencoding()


def safe_print(msg: str, _print=None):
    """Print ``msg``, degrading characters the console encoding cannot
    represent to ``?`` instead of raising UnicodeEncodeError."""
    if not msg:
        return
    if _CONSOLE_ENCODING != 'utf-8':
        msg = (msg.encode(_CONSOLE_ENCODING, errors='replace')
               .decode(_CONSOLE_ENCODING))
    (_print or print)(msg)


def str_to_valid_type(val: str):
    """Parse a regroup-DSL / CLI option argument into its value.

    Grammar (reference utils.py:20-30): '' -> None; '/'-separated values
    become a list whose items are further '*'-split into sublists when they
    contain '*'; otherwise the value is numeric when parseable ('.' selects
    float over int) and the raw string when not.
    """
    if not val:
        return None
    if '/' in val:
        return [item.split('*') if '*' in item else item
                for item in val.split('/')]
    caster = float if '.' in val else int
    try:
        return caster(val)
    except ValueError:
        return val


def isolate_useful_options(options: dict, method, pop: bool = False) -> dict:
    """Pick out (optionally removing) the entries of ``options`` that
    ``method``'s signature accepts."""
    accepted = inspect.signature(method).parameters
    picked = {}
    for key in list(options):
        if key in accepted:
            picked[key] = options.pop(key) if pop else options[key]
    return picked


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = '.') -> str:
    """Render seconds as [HH:]MM:SS.mmm."""
    assert seconds >= 0, 'non-negative timestamp expected'
    total_ms = round(seconds * 1000.0)
    hours, rem = divmod(total_ms, 3_600_000)
    minutes, rem = divmod(rem, 60_000)
    secs, ms = divmod(rem, 1_000)
    body = f'{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}'
    return f'{hours:02d}:{body}' if (hours or always_include_hours) else body


class UnsortedException(Exception):
    """A result's timestamps are not in ascending order.

    Carries the offending data (``.data``) so callers can dump a diagnostic
    JSON, mirroring the reference's raise_for_unsorted contract.
    """
    default_message = ('Timestamps are not in ascending order. If data is '
                       'produced by this library, please submit an issue.')

    def __init__(self, message: Optional[str] = None,
                 data: Optional[dict] = None):
        super().__init__(message or self.default_message)
        self.data = data

    def get_data(self):
        return self.data


def keep_segment_instant_rule(words, max_instant_words: float) -> bool:
    """The ``max_instant_words`` prune shared by both transcribe drivers:
    drop a segment whose fraction of zero-duration words exceeds the
    threshold (reference original_whisper.py:654-663). An empty word list
    is KEPT — the reference computes ``np.mean([]) = NaN`` and
    ``NaN > threshold`` is False."""
    import numpy as np
    if not words:
        return True
    frac = np.mean([w['start'] == w['end'] for w in words])
    return not frac > max_instant_words


def tune_host_allocator(threshold_bytes: int = 256 << 20) -> bool:
    """Keep large host buffers in glibc's main arena so they are REUSED.

    glibc serves any malloc above ~128 KB (dynamically up to 32 MB) via
    mmap and returns it to the OS on free — so every large NumPy array the
    audio/decode pipeline allocates (window stacks, mel inputs, decode
    downloads) is backed by brand-new pages whose first touch page-faults.
    On virtualized hosts with expensive fault-in (measured here: ~40 us per
    4 KB page — a 115 MB copy ran at 99 MB/s fresh vs 3.5 GB/s reused) that
    charges multi-second "host" overhead to what should be memcpys.

    Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes those buffers heap
    allocations that stay cached in the arena across free/alloc cycles.
    No-op (returns False) off glibc or when STABLE_TS_TPU_NO_MALLOC_TUNE
    is set. Fragmentation risk is bounded: the pipeline re-allocates the
    same handful of sizes each group.
    """
    import os
    if os.environ.get('STABLE_TS_TPU_NO_MALLOC_TUNE'):
        return False
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        ok = libc.mallopt(M_MMAP_THRESHOLD, int(threshold_bytes))
        ok &= libc.mallopt(M_TRIM_THRESHOLD, int(threshold_bytes))
        return bool(ok)
    except Exception:
        return False


def timestamp_spans(tokens, ts_begin: int):
    """Cut one window's decoded tokens at consecutive-timestamp pairs.

    The Whisper grammar closes a segment wherever two timestamp tokens
    are adjacent; a lone trailing timestamp closes the final segment at the
    row's end. Returns ``(spans, tail_pos, open_tail)``:

    - ``spans``: list of token sub-arrays, one per segment (empty when the
      row contains no pair — the caller emits a single whole-window
      segment).
    - ``tail_pos``: timestamp offset (in 0.02 s token units, 0 when absent)
      that the seek loop advances by — the closing timestamp of the last
      emitted span, or the last timestamp seen anywhere when no pair
      exists.
    - ``open_tail``: True when the row ended on a lone timestamp (speech
      continues past the window — the seek loop jumps to that timestamp
      instead of a full window stride).
    """
    import numpy as np
    tokens = np.asarray(tokens)
    is_ts = tokens >= ts_begin
    open_tail = (len(tokens) >= 2 and bool(is_ts[-1])
                 and not bool(is_ts[-2]))
    cuts = (np.flatnonzero(is_ts[:-1] & is_ts[1:]) + 1).tolist()
    if not cuts:
        seen = tokens[is_ts]
        tail = int(seen[-1]) - ts_begin if len(seen) else 0
        return [], tail, open_tail
    if open_tail:
        cuts.append(len(tokens))   # lone trailing timestamp closes the row
    spans = [tokens[a:b] for a, b in zip([0] + cuts[:-1], cuts)]
    return spans, int(spans[-1][-1]) - ts_begin, open_tail


def decode_acceptable(result, compression_ratio_threshold,
                      logprob_threshold, no_speech_threshold) -> bool:
    """Temperature-ladder acceptance rule: a rung's result stands unless the
    text is degenerate (too compressible) or too improbable — except that
    likely-silence windows always stand (re-decoding silence hotter only
    hallucinates)."""
    if (no_speech_threshold is not None
            and result.no_speech_prob > no_speech_threshold):
        return True
    if (compression_ratio_threshold is not None
            and result.compression_ratio > compression_ratio_threshold):
        return False
    if (logprob_threshold is not None
            and result.avg_logprob < logprob_threshold):
        return False
    return True


class _NoProgressBar:
    """Fallback when tqdm is unavailable: same surface, renders nothing."""
    disable = True
    n = 0.0

    def update(self, n):
        self.n += n

    def write(self, msg):
        print(msg)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_progress_bar(total, desc: str, verbose):
    """A tqdm progress bar following the reference's display rule: shown
    only when ``verbose`` is exactly False — True prints details instead,
    None displays nothing (reference original_whisper.py:444,
    non_whisper/alignment.py:286, refinement.py:181)."""
    try:
        from tqdm import tqdm
    except ImportError:
        return _NoProgressBar()
    return tqdm(total=round(total, 2) if total else total, unit='sec',
                disable=verbose is not False, desc=desc)


def progress_update(pbar, seconds: float):
    """Advance ``pbar`` to ``seconds`` (monotonic, clamped to its total)."""
    if pbar is None or pbar.disable:
        return
    target = round(seconds, 2)
    if pbar.total is not None:
        target = min(target, pbar.total)
    if target > pbar.n:
        pbar.update(target - pbar.n)
