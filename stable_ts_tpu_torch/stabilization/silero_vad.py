"""Optional Silero-VAD plugin seam.

The reference loads Silero VAD via torch.hub
(stable-ts stable_whisper/stabilization/silero_vad.py). Here Silero is an
*optional plugin*: any callable ``model(chunk_float32[window], sr) -> prob``
satisfies the interface, so tests can inject a fake and offline deployments can
use the built-in energy VAD (:mod:`stable_ts_tpu_torch.stabilization.energy_vad`).
"""
from typing import Callable, List, Optional

import numpy as np

from ..defaults import cached_model_instances

VAD_SAMPLE_RATES = (16000, 8000)
VAD_WINDOWS = {16000: 512, 8000: 256}


def assert_sr_window(sampling_rate: int, window: int):
    assert sampling_rate in VAD_SAMPLE_RATES, \
        f'sampling_rate must be one of {VAD_SAMPLE_RATES} but got {sampling_rate}'
    expected = VAD_WINDOWS[sampling_rate]
    assert window == expected, \
        f'window must be {expected} for sampling_rate {sampling_rate} but got {window}'


def load_silero_vad_model(onnx: bool = False, verbose: Optional[bool] = False, **kwargs):
    """Load and cache Silero VAD via torch.hub (requires network/local cache)."""
    cache = cached_model_instances['silero_vad']
    if cache.get(onnx) is None:
        import torch
        model, utils = torch.hub.load(
            repo_or_dir='snakers4/silero-vad',
            model='silero_vad',
            onnx=onnx,
            trust_repo=True,
            verbose=verbose is not None,
            **kwargs,
        )
        cache[onnx] = (model, utils)
    return cache[onnx]


def compute_vad_probs(
        model: Callable,
        audio: np.ndarray,
        sampling_rate: int,
        window: int = 512,
        progress: bool = True,
) -> List[float]:
    """Sequential per-window speech probabilities from any Silero-style model."""
    assert_sr_window(sampling_rate, window)
    n = audio.shape[-1]
    probs = []
    for start in range(0, n - n % window, window):
        chunk = np.asarray(audio[start:start + window], dtype=np.float32)
        probs.append(float(model(chunk, sampling_rate)))
    return probs


def onnx_param_update(vad, vad_onnx: bool):
    """Fold the deprecated ``vad_onnx`` flag into the vad options."""
    if vad_onnx and isinstance(vad, dict):
        vad = {**vad, 'onnx': True}
    elif vad_onnx and vad is True:
        vad = {'onnx': True}
    return vad
