"""Host-side audio utilities: type coercion and resampling.

Counterpart of stable-ts stable_whisper/audio/utils.py, torch-free.
Waveforms are float32 NumPy arrays in [-1, 1] at 16 kHz unless stated.
Decoding of audio files/bytes is delegated to the native decoder in
``stable_ts_tpu_torch.audio.decode`` (C++ WAV/FLAC reader).
"""
import math
from typing import Optional, Sequence, Union

import numpy as np

from ..constants import SAMPLE_RATE


def resample(audio: np.ndarray, in_sr: int, out_sr: int) -> np.ndarray:
    """Polyphase resample (host-side; scipy kaiser-windowed FIR)."""
    if in_sr == out_sr:
        return audio
    from scipy.signal import resample_poly
    g = math.gcd(int(in_sr), int(out_sr))
    return resample_poly(audio.astype(np.float64), out_sr // g, in_sr // g).astype(np.float32)


def audio_to_numpy_resample(
        audio: Union[np.ndarray, str, bytes, Sequence[float]],
        sr: Optional[int] = None,
        target_srs: Union[int, Sequence[int], None] = None,
) -> np.ndarray:
    """Coerce ``audio`` (path/bytes/array) to mono float32 at a target rate.

    ``target_srs`` may be a single rate or a sequence of acceptable rates
    (the first is used when resampling is needed). Defaults to 16 kHz.
    """
    if target_srs is None:
        target_srs = (SAMPLE_RATE,)
    elif isinstance(target_srs, int):
        target_srs = (target_srs,)
    if isinstance(audio, (str, bytes)):
        from .decode import decode_audio
        audio, sr = decode_audio(audio, sr=target_srs[0])
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    else:
        # copy=False: an already-float32 source (the common array input)
        # passes through without a full-length copy — the loader never
        # mutates it, and downstream chunking slices views anyway
        audio = audio.astype(np.float32, copy=False)
    if audio.ndim == 2:  # downmix (channels, samples) or (samples, channels)
        audio = audio.mean(axis=0 if audio.shape[0] < audio.shape[1] else 1)
    if sr is not None and sr not in target_srs:
        audio = resample(audio, sr, target_srs[0])
    return audio


def get_metadata(audiofile) -> dict:
    """Best-effort ``dict(sr=..., duration=...)`` without a full decode.

    Counterpart of reference audio/utils.py:152-183. Arrays are assumed to
    be 16 kHz; WAV/FLAC paths/bytes are probed from their headers (native,
    no subprocess); other containers fall back to parsing ``ffmpeg -i``'s
    banner, which works for any format/URL ffmpeg can open.
    """
    if isinstance(audiofile, np.ndarray):
        return dict(sr=SAMPLE_RATE, duration=audiofile.shape[-1] / SAMPLE_RATE)
    from .decode import get_metadata as probe_headers
    try:
        meta = probe_headers(audiofile)
    except (OSError, ValueError):
        meta = dict(sr=None, duration=None)
    if meta.get('sr'):
        return meta
    return _ffmpeg_metadata(audiofile)


def _ffmpeg_metadata(audiofile) -> dict:
    """Parse sample rate + duration out of ``ffmpeg -i``'s stderr banner."""
    import re
    import subprocess
    cmd = ['ffmpeg', '-hide_banner', '-i']
    try:
        if isinstance(audiofile, str):
            banner = subprocess.run(cmd + [audiofile],
                                    capture_output=True).stderr
        else:
            proc = subprocess.Popen(cmd + ['-'], stdin=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            try:
                proc.stdin.write(audiofile)
            except BrokenPipeError:
                pass
            banner = proc.communicate()[-1]
    except FileNotFoundError:  # no ffmpeg on PATH
        return dict(sr=None, duration=None)
    banner = (banner or b'').decode(errors='ignore')
    sr_match = re.findall(r'\n.+Stream.+Audio.+\D+(\d+) Hz', banner)
    dur_match = re.findall(r'Duration: ([\d:]+\.\d+),', banner)
    duration = None
    if dur_match:
        h, m, s = dur_match[0].split(':')
        duration = int(h) * 3600 + int(m) * 60 + float(s)
    return dict(sr=int(sr_match[0]) if sr_match else None, duration=duration)


def get_samplerate(audiofile) -> Optional[int]:
    return get_metadata(audiofile).get('sr')


def voice_freq_filter(audio: np.ndarray, sr: int,
                      upper_freq: Optional[int] = None,
                      lower_freq: Optional[int] = None) -> np.ndarray:
    """Band-pass to the voice band (default 200-5000 Hz), biquad like the reference."""
    from scipy.signal import butter, sosfilt
    if upper_freq is None:
        upper_freq = 5000
    if lower_freq is None:
        lower_freq = 200
    assert upper_freq > lower_freq, 'upper_freq must be greater than lower_freq'
    sos = butter(2, [lower_freq, upper_freq], btype='bandpass', fs=sr, output='sos')
    return sosfilt(sos, audio.astype(np.float64)).astype(np.float32)
