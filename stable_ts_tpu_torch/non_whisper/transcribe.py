"""Adapter: transcribe with ANY ASR system and stabilize its timestamps.

Behavioral counterpart of stable-ts stable_whisper/non_whisper/transcribe.py
(transcribe_any:26): coerce ``audio`` into the type/sample-rate the user's
``inference_func`` expects (path / bytes / float32 ndarray), optionally
denoise and voice-band filter, call the function, wrap its output in a
:class:`WhisperResult`, then apply silence suppression and regrouping.

torch-free: 'numpy' replaces the reference's 'torch' audio type (any backend
that wants tensors converts trivially); WAV round-trips use the stdlib.
"""
import io
import os
import warnings
from typing import Callable, Optional, Union

import numpy as np

from ..audio.decode import decode_audio, get_metadata
from ..audio.utils import resample, voice_freq_filter
from ..defaults import get_min_word_dur
from ..result import WhisperResult

AUDIO_TYPES = ('str', 'byte', 'numpy', 'torch', None)


def _repair_none_ts(result, total_dur: Optional[float]) -> None:
    """Repair None start/end timestamps in a backend's raw output, in
    place, before WhisperResult ingestion (which would otherwise crash
    ``force_order``/sorting). Same interpolation rules as the reference's
    HF backend (hf_whisper.py:160-227 ``replace_none_ts``) — see
    result/repair.py. Accepts every input form WhisperResult does."""
    from ..result.repair import replace_none_ts, repair_result_timestamps
    if isinstance(result, dict):
        segments = result.get('segments')
    elif isinstance(result, list) and result and isinstance(result[0], list):
        # list of word-dict lists: repair the flat word stream (segment
        # spans derive from the words during construction)
        words = [w for seg_words in result for w in seg_words]
        if any(w.get('start') is None or w.get('end') is None
               for w in words):
            replace_none_ts(words, total_dur)
        return
    elif isinstance(result, list):
        segments = result
    else:
        return
    if segments and any(
            seg.get('start') is None or seg.get('end') is None
            or any(w.get('start') is None or w.get('end') is None
                   for w in seg.get('words') or ())
            for seg in segments):
        repair_result_timestamps(segments, total_dur)


def _encode_wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    import wave
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype('<i2').tobytes())
    return buf.getvalue()


def transcribe_any(
        inference_func: Callable,
        audio: Union[str, np.ndarray, bytes],
        audio_type: Optional[str] = None,
        input_sr: Optional[int] = None,
        model_sr: Optional[int] = None,
        inference_kwargs: Optional[dict] = None,
        temp_file: Optional[str] = None,
        verbose: Optional[bool] = False,
        regroup: Union[bool, str] = True,
        suppress_silence: bool = True,
        suppress_word_ts: bool = True,
        q_levels: int = 20,
        k_size: int = 5,
        denoiser: Optional[str] = None,
        denoiser_options: Optional[dict] = None,
        vad: Union[bool, dict] = False,
        vad_threshold: float = 0.35,
        vad_onnx: bool = False,
        min_word_dur: Optional[float] = None,
        min_silence_dur: Optional[float] = None,
        nonspeech_error: float = 0.1,
        use_word_position: bool = True,
        only_voice_freq: bool = False,
        force_order: bool = False,
        check_sorted: bool = True,
        demucs=None,
        demucs_options: Optional[dict] = None,
        only_ffmpeg: bool = False,
) -> WhisperResult:
    """Run ``inference_func`` on ``audio`` and stabilize the result.

    ``inference_func(audio=..., **inference_kwargs)`` must return a
    WhisperResult-compatible mapping (dict with 'segments', list of segment
    dicts, list of word-dict lists, or a WhisperResult).
    """
    if audio_type is not None:
        audio_type = audio_type.lower()
    if audio_type == 'torch':
        # Accepted for API parity; backends get float32 numpy and can convert.
        audio_type = 'numpy'
    assert audio_type in AUDIO_TYPES, f'``audio_type`` must be one of {AUDIO_TYPES}'
    if isinstance(audio, np.ndarray) and input_sr is None:
        raise ValueError('``input_sr`` is required when ``audio`` is an array')

    from ..audio.denoiser import convert_demucs_kwargs
    denoiser, denoiser_options = convert_demucs_kwargs(
        denoiser, denoiser_options, demucs=demucs, demucs_options=demucs_options)
    inference_kwargs = dict(inference_kwargs or {})
    min_word_dur = get_min_word_dur(min_word_dur)
    if temp_file is None:
        temp_file = './_temp_stable-ts_audio_.wav'
    temp_file = os.path.abspath(temp_file)
    temp_audio_file = None

    if audio_type is None:
        if isinstance(audio, str):
            audio_type = 'str'
        elif isinstance(audio, bytes):
            audio_type = 'byte'
        else:
            audio_type = 'numpy'

    # -- establish a decoded waveform + sample rate for preprocessing/suppression --
    if isinstance(audio, (str, bytes)):
        if isinstance(audio, str):
            # URL sources resolve like the reference (file:// -> path,
            # yt-dlp -> bytes, else left for ffmpeg; transcribe.py:181)
            from ..audio.source import load_source
            audio = load_source(audio, verbose=verbose,
                                only_ffmpeg=only_ffmpeg)
        if input_sr is None:
            input_sr = get_metadata(audio).get('sr')
        decoded, decoded_sr = decode_audio(audio)
    else:
        decoded = np.asarray(audio, np.float32)
        decoded_sr = input_sr
    if input_sr is None:
        input_sr = decoded_sr

    preprocessed = False
    work = decoded
    work_sr = decoded_sr
    if denoiser:
        from ..audio.denoiser import apply_denoiser
        if work_sr != 16000:
            work = resample(work, work_sr, 16000)
            work_sr = 16000
        work = apply_denoiser(denoiser, work, **(denoiser_options or {}))
        preprocessed = True
    if only_voice_freq:
        work = voice_freq_filter(work, work_sr)
        preprocessed = True

    # -- produce the audio object the backend expects -------------------------------
    final_sr = model_sr or work_sr
    final_wave = resample(work, work_sr, final_sr) if work_sr != final_sr else work

    if audio_type == 'numpy':
        final_audio = final_wave.astype(np.float32)
    elif audio_type == 'byte':
        if isinstance(audio, bytes) and not preprocessed and model_sr in (None, work_sr):
            final_audio = audio
        else:
            final_audio = _encode_wav_bytes(final_wave, final_sr)
    else:  # 'str'
        if isinstance(audio, str) and not preprocessed and model_sr in (None, work_sr):
            final_audio = audio
        else:
            from ..audio.output import save_audio
            save_audio(final_wave, temp_file, final_sr)
            final_audio = temp_audio_file = temp_file

    inference_kwargs['audio'] = final_audio

    try:
        result = inference_func(**inference_kwargs)
        if not isinstance(result, WhisperResult):
            _repair_none_ts(result, round(work.shape[-1] / work_sr, 3)
                            if work_sr else None)
            result = WhisperResult(result, force_order=force_order,
                                   check_sorted=check_sorted)
        if suppress_silence:
            result.adjust_by_silence(
                work, vad,
                vad_onnx=vad_onnx, vad_threshold=vad_threshold,
                q_levels=q_levels, k_size=k_size,
                sample_rate=work_sr, min_word_dur=min_word_dur,
                word_level=suppress_word_ts, verbose=verbose,
                nonspeech_error=nonspeech_error,
                use_word_position=use_word_position,
                min_silence_dur=min_silence_dur,
            )
            result.set_current_as_orig()
        if result.has_words and regroup:
            result.regroup(regroup)
    finally:
        if temp_audio_file is not None:
            try:
                os.unlink(temp_audio_file)
            except Exception as exc:
                warnings.warn(f'Failed to remove temporary audio file '
                              f'{temp_audio_file}. {exc}')
    return result
