"""Audio front end: decoding, streaming, preprocessing.

The full streaming ``AudioLoader`` lives in :mod:`stable_ts_tpu_torch.audio.loader`;
this package exposes the one-shot :func:`prep_audio` plus the loader itself.
"""
from typing import Optional, Union

import numpy as np

from .utils import audio_to_numpy_resample
from ..constants import SAMPLE_RATE

__all__ = ['prep_audio', 'audio_to_numpy_resample', 'AudioLoader', 'SUPPORTED_DENOISERS']


def prep_audio(
        audio,
        denoiser: Optional[str] = None,
        denoiser_options: Optional[dict] = None,
        only_voice_freq: bool = False,
        sr: Optional[int] = None,
) -> np.ndarray:
    """One-shot load + resample(16k) + optional denoise / voice-band filter."""
    from .source import is_url, load_source
    if is_url(audio):
        audio = load_source(audio)
    audio = audio_to_numpy_resample(audio, sr, SAMPLE_RATE)
    if denoiser:
        from .denoiser import apply_denoiser
        audio = apply_denoiser(denoiser, audio, **(denoiser_options or {}))
    if only_voice_freq:
        from .utils import voice_freq_filter
        audio = voice_freq_filter(audio, SAMPLE_RATE)
    return audio


def __getattr__(name):
    # Lazy imports keep `import stable_ts_tpu_torch` light.
    if name == 'AudioLoader':
        from .loader import AudioLoader
        return AudioLoader
    if name == 'SUPPORTED_DENOISERS':
        from .denoiser import SUPPORTED_DENOISERS
        return SUPPORTED_DENOISERS
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
