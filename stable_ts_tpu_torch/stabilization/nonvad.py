"""Loudness-based (non-VAD) silence detection, pure NumPy.

Behavioral counterpart of stable-ts stable_whisper/stabilization/nonvad.py:
downsample |waveform| to one unit per Whisper token (20 ms) via linear
interpolation, normalize by the top-0.1% loudness, smooth with a
reflect-padded moving average, quantize, and mark quiet runs longer than
0.1 s as silence. No torch: everything is NumPy array math (cheap host-side
work; the waveform never needs to touch the accelerator for this).
"""
from typing import Optional, Tuple, Union

import numpy as np

from .utils import mask2timing, timing2mask
from ..constants import N_SAMPLES_PER_TOKEN

NONVAD_SAMPLE_RATES = (16000,)


def _linear_resample(x: np.ndarray, out_size: int) -> np.ndarray:
    """1-D linear interpolation BIT-EQUAL to torch's CPU
    ``F.interpolate(mode='linear', align_corners=False)``.

    Exactness matters: the quantization step downstream (``round(x * 20)``)
    turns a 1-ulp difference at a 0.025 boundary into a flipped silence
    unit, which the transcribe parity suite then sees as a 0.02-s
    nonspeech-section shift. Torch computes source coordinates in float32
    (lower-clamped only) and the lerp as ``fma(l0, x_lo, l1 * x_hi)``;
    the fma's single rounding is reproduced via a float64 intermediate
    (exact for float32 products)."""
    in_size = x.shape[-1]
    scale = np.float32(in_size) / np.float32(out_size)
    i = np.arange(out_size, dtype=np.float32)
    src = np.maximum(np.float32(0),
                     scale * (i + np.float32(0.5)) - np.float32(0.5))
    lo = src.astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo.astype(np.float32)).astype(np.float32)
    l0 = np.float32(1) - frac
    return (l0.astype(np.float64) * x[lo].astype(np.float64)
            + (frac * x[hi]).astype(np.float64)).astype(np.float32)


def _moving_average_reflect(x: np.ndarray, k_size: int) -> np.ndarray:
    """Stride-1 average pool with reflect padding, BIT-EQUAL to torch's
    ``avg_pool1d``: sequential float32 window sum, then a float32 divide
    (float64 accumulation rounds differently ~1e-3 of the time)."""
    p = k_size // 2
    padded = np.pad(x, p, mode='reflect')
    win = np.lib.stride_tricks.sliding_window_view(padded, k_size)
    acc = win[:, 0].astype(np.float32)
    for j in range(1, k_size):
        acc = acc + win[:, j]
    return acc / np.float32(k_size)


def _kth_largest(x: np.ndarray, k: int) -> np.floating:
    """Exact k-th largest order statistic via chunked partial selection.

    ``np.partition`` on the whole array copies it first; on this host a
    30-min waveform's fresh 115 MB copy page-faults for ~2 s. Every global
    top-k element is inside its own chunk's top-k, so selecting within a
    small reused scratch and then over the union of chunk tops returns the
    identical value with no full-size allocation.
    """
    n = x.size
    chunk = 1 << 22  # 16 MB float32 scratch
    if n <= chunk or k >= n:
        return np.partition(x, n - k)[n - k]
    buf = np.empty(chunk, dtype=x.dtype)
    tops = []
    for i in range(0, n, chunk):
        c = x[i:i + chunk]
        m = c.size
        kk = min(k, m)
        view = buf if m == chunk else c.copy()
        if view is buf:
            np.copyto(buf, c)
        view.partition(m - kk)
        tops.append(view[m - kk:].copy())
    union = np.concatenate(tops)
    union.partition(union.size - k)
    return union[union.size - k]


def audio2loudness(
        audio: np.ndarray,
        samples_per_unit: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Normalized per-token loudness curve, or None for too-short audio."""
    audio = np.asarray(audio, dtype=np.float32)
    assert audio.ndim == 1, f'waveform must be 1D, but got {audio.ndim}D'
    loud = np.abs(audio)
    k = int(loud.size * 0.001)
    if k:
        # k-th largest value = top-0.1% threshold.
        threshold = _kth_largest(loud, k)
    else:
        threshold = np.quantile(loud, 0.999)
    if samples_per_unit is None:
        samples_per_unit = N_SAMPLES_PER_TOKEN
    token_count = round(loud.shape[-1] / samples_per_unit) + 1
    if token_count <= 2:
        return None
    if threshold < 1e-5:
        return np.zeros(token_count, dtype=loud.dtype)
    loud /= min(1.0, float(threshold) * 1.75)  # in place: loud is our abs()
    return _linear_resample(loud, token_count)


def wav2mask(
        audio: np.ndarray,
        q_levels: int = 20,
        k_size: int = 5,
        sr: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Bool mask (one unit per token) that is True where audio is silent."""
    from ..audio.utils import audio_to_numpy_resample
    audio = audio_to_numpy_resample(audio, sr, NONVAD_SAMPLE_RATES)
    loudness = audio2loudness(audio)
    if loudness is None:
        return None
    p = k_size // 2 if k_size else 0
    if p and p < loudness.shape[-1]:
        assert k_size % 2, f'kernel_size must be odd but got {k_size}'
        smoothed = _moving_average_reflect(loudness, k_size)
    else:
        smoothed = loudness.copy()
    if q_levels:
        smoothed = np.round(smoothed * q_levels)
    loud_mask = smoothed.astype(bool)
    if not loud_mask.any():  # entirely silent
        return ~loud_mask
    # Keep only loud runs longer than 0.1 s; everything else is silence.
    timings = mask2timing(loud_mask)
    starts, ends = timings
    long_enough = (ends - starts) > 0.1
    starts, ends = starts[long_enough], ends[long_enough]
    silence_mask = ~timing2mask(starts, ends, loudness.shape[-1])
    if not silence_mask.any():  # no silence
        return None
    return silence_mask


def audio2timings(
        audio: np.ndarray,
        q_levels: int = 20,
        k_size: int = 5,
        sr: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Silent-section (starts, ends) in seconds for ``audio``."""
    return mask2timing(wav2mask(audio, q_levels=q_levels, k_size=k_size, sr=sr))


def visualize_mask(
        loudness: np.ndarray,
        silence_mask: Optional[np.ndarray] = None,
        width: int = 1500,
        height: int = 200,
        output: Optional[str] = None,
):
    """Render the loudness curve with silent regions in red; save/show a PNG."""
    no_silence = silence_mask is None or not silence_mask.any()
    assert no_silence or silence_mask.shape[0] == loudness.shape[0]
    if loudness.shape[0] < 2:
        raise NotImplementedError(
            f'audio size, {loudness.shape[0]}, is too short to visualize')
    width = loudness.shape[0] if width == -1 else width
    im = np.zeros((height, width, 3), dtype=np.uint8)
    mid = round(height / 2)
    for i, v in enumerate(loudness.tolist()):
        j = round(abs(v) * mid)
        if j == 0 or width <= i:
            continue
        im[mid - j:mid + 1, i] = 255
        im[mid + 1:mid + j + 1, i] = 255
    if not no_silence:
        im[:, silence_mask[:width], 1:] = 0
    if output and not output.endswith('.png'):
        output += '.png'
    try:
        from PIL import Image
    except ModuleNotFoundError as exc:
        raise ModuleNotFoundError(
            'Pillow is required to visualize the suppression mask '
            '("pip install Pillow").') from exc
    img = Image.fromarray(im)
    if isinstance(output, str):
        img.save(output)
        print(f'Save: {output}')
    else:
        img.show()
