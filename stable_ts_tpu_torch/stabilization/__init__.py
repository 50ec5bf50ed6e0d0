"""Silence detection and timestamp stabilization.

Host-side orchestration of the silence detectors (loudness-based non-VAD,
Silero-style VAD plugin, or exact zero-sample masks) plus the timestamp
clipping rule. Counterpart of stable-ts stable_whisper/stabilization/.

Design notes (TPU build): the three prediction strategies share one
``_package`` result builder, word-length thresholds for each unit system
(samples / mel frames / VAD windows) are derived in one place, and silence
accumulation is vectorized with numpy instead of per-element list walks.
"""
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from .nonvad import NONVAD_SAMPLE_RATES, audio2loudness, audio2timings, wav2mask, visualize_mask
from .silence import suppress_silence
from .silero_vad import (VAD_SAMPLE_RATES, assert_sr_window, compute_vad_probs,
                         load_silero_vad_model, onnx_param_update)
from .utils import (filter_timings, is_ascending_sequence, mask2timing, timing2mask,
                    valid_ts)
from ..constants import FRAMES_PER_SECOND, N_SAMPLES_PER_TOKEN, SAMPLE_RATE
from ..defaults import get_min_word_dur

__all__ = ['NonSpeechPredictor', 'suppress_silence', 'get_vad_silence_func',
           'visualize_suppression', 'mask2timing', 'timing2mask', 'filter_timings',
           'wav2mask', 'audio2timings', 'audio2loudness', 'valid_ts',
           'VAD_SAMPLE_RATES', 'NONVAD_SAMPLE_RATES']

# mel-mask length = N_FRAMES (3000) / 2 + 1 (reference stabilization pads
# timestamp-token masks to this length)
_TS_MASK_LEN = 1501


class NonSpeechPredictor:
    """Per-chunk silence prediction with streaming accumulation.

    Strategy dispatch mirrors the reference (stabilization/__init__.py:69-72):
    ``vad=None`` -> exact zero-sample mask; ``vad=False`` -> loudness non-VAD;
    ``vad=True``/dict -> Silero-style VAD plugin; ``vad='energy'`` -> built-in
    energy VAD (TPU-build extension, usable offline).
    """

    def __init__(self, vad: Optional[Union[bool, dict]] = False,
                 mask_pad_func: Optional[Callable] = None,
                 get_mask: bool = False,
                 min_word_dur: Optional[float] = None,
                 q_levels: int = 20, k_size: int = 5,
                 vad_threshold: float = 0.35, vad_onnx: bool = False,
                 vad_window: Optional[int] = None,
                 sampling_rate: Optional[int] = None,
                 verbose: Optional[bool] = True,
                 store_timings: bool = False,
                 ignore_is_silent: bool = False,
                 stream: bool = False,
                 units_per_seconds: Optional[int] = None,
                 min_silence_dur: Optional[float] = None):
        vad = self._named_vad(vad)
        vad_options = onnx_param_update(vad, vad_onnx)
        # tri-state: None = exact samples, False = loudness, True = VAD model
        self.vad = None if vad is None else (vad_options is not False)
        self._vad_options = (vad_options
                             if self.vad and isinstance(vad_options, dict) else {})
        self.mask_pad_func, self.get_mask = mask_pad_func, get_mask
        self.q_levels, self.k_size = q_levels, k_size
        self.vad_threshold, self.verbose = vad_threshold, verbose
        self.store_timings = store_timings
        self.ignore_is_silent = ignore_is_silent
        self.min_silence_dur = min_silence_dur
        self._stream = stream
        self._nonspeech_timings: Optional[Tuple[list, list]] = None
        self.vad_window = 512 if vad_window is None else vad_window
        self.sampling_rate = SAMPLE_RATE if sampling_rate is None else sampling_rate
        self._derive_word_thresholds(get_min_word_dur(min_word_dur),
                                     units_per_seconds or FRAMES_PER_SECOND)
        if self.vad:
            assert_sr_window(self.sampling_rate, self.vad_window)
        self.second_per_prob = self.vad_window / self.sampling_rate
        self.vad_model = None
        self._default_probs: List[float] = []
        self._prev_speech_probs: List[float] = []
        self._using_callback = False
        self._load_vad_model()
        self._predict = {None: self.predict_with_samples,
                         False: self.predict_with_nonvad,
                         True: self.predict_with_vad}[self.vad]

    @staticmethod
    def _named_vad(vad):
        if not isinstance(vad, str):
            return vad
        if vad != 'energy':
            raise ValueError(f"unknown VAD name: {vad!r}; use 'energy', "
                             f"True (Silero), a dict, False, or None")
        from .energy_vad import EnergyVAD
        return {'model': EnergyVAD()}

    def _derive_word_thresholds(self, min_word_dur: float, units_per_seconds: int):
        """Minimum word length expressed in each strategy's native unit."""
        sr = self.sampling_rate
        self.min_samples_per_word = round(min_word_dur * sr)
        self.min_frames_per_word = max(round(min_word_dur * units_per_seconds), 1)
        self.min_chunks_per_word = round(min_word_dur * sr / self.vad_window)

    @property
    def nonspeech_timings(self):
        return self._nonspeech_timings

    def predict(self, audio: np.ndarray, offset: Optional[float] = None) -> dict:
        pred = self._predict(audio, offset)
        if self.min_silence_dur:
            pred['timings'] = filter_timings(pred['timings'], self.min_silence_dur)
        return pred

    def _load_vad_model(self):
        if not self.vad:
            return
        options = dict(self._vad_options)
        self.vad_model = (options.pop('model', None)
                          or load_silero_vad_model(**options)[0])
        self.reset()

    def reset(self):
        if hasattr(self.vad_model, 'reset_states'):
            self.vad_model.reset_states()
        self._prev_speech_probs = []

    # -- shared helpers ------------------------------------------------------------

    def _package(self, timings, mask, is_silent: bool) -> dict:
        """Common result shape; also feeds the running silence accumulator."""
        self._append_timings(timings)
        return dict(timings=timings, mask=mask, is_silent=is_silent)

    def _silent_mask_test(self, mask, min_unit_per_word) -> bool:
        """True when the chunk has fewer non-silent units than one word needs."""
        if self.ignore_is_silent or mask is None:
            return False
        speech_units = mask.shape[-1] - int(np.count_nonzero(mask))
        return speech_units < min_unit_per_word

    def _append_timings(self, timings):
        if not self.store_timings or timings is None or not len(timings[0]):
            return
        starts, ends = (np.asarray(t).tolist() for t in timings)
        if self._nonspeech_timings is None:
            self._nonspeech_timings = (starts, ends)
        elif starts:
            self._nonspeech_timings[0].extend(starts)
            self._nonspeech_timings[1].extend(ends)

    def finalize_timings(self):
        """Sort and recursively merge overlapping accumulated silence sections."""
        if self._nonspeech_timings is None:
            return

        def merge(starts: np.ndarray, ends: np.ndarray):
            if len(starts) > 1:
                disjoint = starts[1:] >= ends[:-1]
                if not disjoint.all():
                    keep_start = np.concatenate(([True], disjoint))
                    keep_end = np.concatenate((disjoint, [True]))
                    return merge(starts[keep_start], ends[keep_end])
            return starts, ends

        starts, ends = (np.sort(np.array(t)) for t in self._nonspeech_timings)
        starts, ends = merge(starts, ends)
        self._nonspeech_timings = starts.tolist(), ends.tolist()

    def pad_mask(self, mask):
        if mask is None or self.mask_pad_func is None:
            return mask
        return self.mask_pad_func(mask, _TS_MASK_LEN)

    # -- VAD path -------------------------------------------------------------------

    def compute_vad_probs(self, audio: np.ndarray) -> List[float]:
        return compute_vad_probs(model=self.vad_model, audio=audio,
                                 sampling_rate=self.sampling_rate,
                                 window=self.vad_window,
                                 progress=self.verbose is not None)

    def _nonstream_prep_callback(self, prepped_audio, **kwargs):
        if not self._default_probs:
            self._default_probs = self.compute_vad_probs(prepped_audio)

    def _stream_prep_callback(self, prepped_audio, **kwargs):
        self._default_probs.extend(self.compute_vad_probs(prepped_audio))

    def get_on_prep_callback(self, stream: Optional[bool] = None):
        if not self.vad:
            return None
        self._using_callback = True
        if stream is not None:
            self._stream = stream
        return (self._stream_prep_callback if self._stream
                else self._nonstream_prep_callback)

    def _vad_probs(self, audio: np.ndarray, offset: Optional[float] = None):
        """Per-window speech probabilities for this chunk (+ aligned offset).

        When probabilities were pre-computed by an audio-prep callback, slice
        the chunk's windows out of the accumulated sequence instead of
        re-running the model.
        """
        if not self._default_probs:
            assert not self._using_callback
            return self.compute_vad_probs(audio), offset
        assert offset is not None, 'offset is required for default probs'
        first_sample = offset * self.sampling_rate
        lo = int(np.floor(first_sample / self.vad_window))
        hi = int(np.ceil((first_sample + audio.shape[-1]) / self.vad_window))
        aligned_offset = lo * self.vad_window / self.sampling_rate
        return self._default_probs[lo:hi], aligned_offset

    def predict_with_vad(self, audio: np.ndarray, offset: Optional[float] = None) -> dict:
        if offset is None:
            offset = 0
        chunk_end = round(offset + audio.shape[-1] / self.sampling_rate, 3)
        speech_probs, aligned_offset = self._vad_probs(audio, offset=offset)
        silence = np.less(speech_probs, self.vad_threshold)
        is_silent = self._silent_mask_test(silence, self.min_chunks_per_word)
        timings = mask2timing(silence, time_offset=aligned_offset,
                              second_per_unit=self.second_per_prob,
                              min_start=offset, max_end=chunk_end)
        mask = None
        if timings is not None:
            if self.get_mask:
                mask = timing2mask(*timings, time_offset=aligned_offset,
                                   size=_TS_MASK_LEN)
            timings = np.stack(timings, axis=0)
        self._prev_speech_probs = speech_probs
        return self._package(timings, mask, is_silent)

    # -- non-VAD path --------------------------------------------------------------------

    def predict_with_nonvad(self, audio: np.ndarray, offset: Optional[float] = None) -> dict:
        silence = wav2mask(audio, q_levels=self.q_levels, k_size=self.k_size,
                           sr=self.sampling_rate)
        timings = mask2timing(silence, time_offset=offset)
        if timings is not None:
            timings = np.stack(timings, axis=0)
        is_silent = self._silent_mask_test(silence, self.min_frames_per_word)
        return self._package(timings, self.pad_mask(silence), is_silent)

    # -- exact-sample path ------------------------------------------------------------------

    def predict_with_samples(self, audio: np.ndarray, offset: Optional[float] = None) -> dict:
        if self.get_mask:
            # token-resolution mask: one unit per 20 ms of samples
            short = -audio.shape[-1] % N_SAMPLES_PER_TOKEN
            if short:
                audio = np.pad(audio, (0, short))
            silence = np.all(audio.reshape(-1, N_SAMPLES_PER_TOKEN) == 0, axis=-1)
            threshold = self.min_frames_per_word
        else:
            silence = audio == 0
            threshold = self.min_samples_per_word
        is_silent = self._silent_mask_test(silence, threshold)
        mask = self.pad_mask(silence) if self.get_mask else None
        return dict(timings=None, mask=mask, is_silent=is_silent)


def get_vad_silence_func(onnx: bool = False, verbose: Optional[bool] = False, **kwargs):
    """Return ``f(audio, speech_threshold, sr, time_offset) -> (starts, ends)``."""
    vad_onnx = kwargs.pop('vad_onnx', False)
    predictor = NonSpeechPredictor(vad=dict(onnx=onnx, **kwargs),
                                   vad_onnx=vad_onnx, verbose=verbose)

    def vad_silence_timing(audio, speech_threshold: float = .35,
                           sr: Optional[int] = None,
                           time_offset: Optional[float] = None):
        from ..audio import prep_audio
        if sr:
            predictor.sampling_rate = sr
        predictor.vad_threshold = speech_threshold
        prepped = prep_audio(audio)
        return predictor.predict_with_vad(audio=prepped, offset=time_offset)['timings']

    return vad_silence_timing


def visualize_suppression(audio, output: Optional[str] = None,
                          q_levels: int = 20, k_size: int = 5,
                          vad_threshold: float = 0.35,
                          vad: Union[bool, dict] = False,
                          max_width: int = 1500, height: int = 200, **kwargs):
    """Render detected-silence regions over the waveform to a PNG."""
    from ..audio.utils import audio_to_numpy_resample
    audio = audio_to_numpy_resample(audio)
    max_n_samples = None if max_width == -1 else round(max_width * N_SAMPLES_PER_TOKEN)
    if max_n_samples is not None:
        audio = audio[:max_n_samples]
    loudness = audio2loudness(audio)
    if loudness is None:
        raise NotImplementedError('Audio is too short and cannot be visualized.')
    if max_n_samples is None:
        max_width = loudness.shape[-1]
    if vad:
        silence_timings = get_vad_silence_func(
            **(vad if isinstance(vad, dict) else {}))(audio, vad_threshold, **kwargs)
        silence_mask = (None if silence_timings is None
                        else timing2mask(*silence_timings, size=loudness.shape[0]))
    else:
        silence_mask = wav2mask(audio, q_levels=q_levels, k_size=k_size, **kwargs)
    visualize_mask(loudness, silence_mask,
                   width=min(max_width, loudness.shape[-1]),
                   height=height, output=output)
