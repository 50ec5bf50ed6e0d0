"""faster-whisper (CTranslate2) backend adapter.

Behavioral counterpart of
stable-ts stable_whisper/whisper_word_level/faster_whisper.py and the
faster-whisper branches of its alignment.py (:478-507 word timing,
:725-751 refine probs): a loaded ``faster_whisper.WhisperModel`` gains the
stabilized ``.transcribe()`` (original kept as ``.transcribe_original``),
the batched pipeline, and ``.align()/.align_words()/.refine()`` backed by
this package's engine-agnostic Aligner/Refiner.

faster-whisper itself is an optional dependency — everything here imports
it lazily and fails with an instructive message when absent. The dispatch
and conversion logic is covered offline by fake-module tests
(tests/test_torch_fw_backend.py); the real CTranslate2 model is not
exercised by the tests.
"""
import warnings
from types import MethodType
from typing import Callable, List, Optional, Union

import numpy as np

from ..result import Segment, WhisperResult
from ..utils import safe_print

_INSTALL_HINT = ('faster-whisper is not installed. The PyTorch engine '
                 '(stable_ts_tpu_torch.load_model) is the fast backend here; to '
                 'use a CTranslate2 model install faster-whisper.')


def is_faster_whisper_model(model) -> bool:
    """True for a (real or fake) faster_whisper.WhisperModel — something
    with a CTranslate2 core and a feature extractor but no ``params``."""
    return (not hasattr(model, 'params')
            and hasattr(model, 'feature_extractor')
            and hasattr(model, 'model'))


class FwTokenizerShim:
    """Adapt a ``faster_whisper.tokenizer.Tokenizer`` to the attribute
    surface this package's Aligner/Refiner expect (``sot_sequence``,
    ``no_timestamps``, ``eot``, ``timestamp_begin``, encode/decode)."""

    def __init__(self, fw_tokenizer, language: Optional[str]):
        self._t = fw_tokenizer
        self.language = language or getattr(fw_tokenizer, 'language_code', 'en')

    def encode(self, text: str) -> List[int]:
        return list(self._t.encode(text))

    def decode(self, tokens) -> str:
        return self._t.decode(list(tokens))

    @property
    def sot_sequence(self):
        seq = getattr(self._t, 'sot_sequence', None)
        if seq is not None:
            return tuple(seq)
        # minimal multilingual sequence: <sot> <language> <task>
        return (self._t.sot,)

    @property
    def eot(self) -> int:
        return self._t.eot

    @property
    def no_timestamps(self) -> int:
        return self._t.no_timestamps

    @property
    def timestamp_begin(self) -> int:
        return self._t.timestamp_begin

    def __getattr__(self, name):
        return getattr(self._t, name)


def fw_tokenizer(model, language: Optional[str], task: str = 'transcribe'):
    """Build the tokenizer for a faster-whisper model (reference
    whisper_compatibility.get_tokenizer's fw branch)."""
    from faster_whisper.tokenizer import Tokenizer
    multilingual = bool(getattr(model.model, 'is_multilingual', True))
    if not multilingual:
        language = 'en'
    return FwTokenizerShim(
        Tokenizer(model.hf_tokenizer, multilingual, task=task,
                  language=language),
        language)


# -- stabilized transcribe -------------------------------------------------------------


def faster_transcribe(
        model,
        audio: Union[str, bytes, np.ndarray],
        *,
        word_timestamps: bool = True,
        verbose: Optional[bool] = False,
        regroup: Union[bool, str] = True,
        suppress_silence: bool = True,
        suppress_word_ts: bool = True,
        use_word_position: bool = True,
        q_levels: int = 20,
        k_size: int = 5,
        denoiser: Optional[str] = None,
        denoiser_options: Optional[dict] = None,
        vad: Union[bool, dict] = False,
        vad_threshold: float = 0.35,
        min_word_dur: Optional[float] = None,
        min_silence_dur: Optional[float] = None,
        nonspeech_error: float = 0.1,
        only_voice_freq: bool = False,
        only_ffmpeg: bool = False,
        check_sorted: bool = True,
        progress_callback: Optional[Callable] = None,
        **options,
) -> WhisperResult:
    """Transcribe with faster-whisper, then stabilize through this
    package's silence/VAD suppression and regroup pipeline
    (reference faster_whisper.py:16-180)."""
    from ..non_whisper import transcribe_any

    if not isinstance(audio, (str, bytes, np.ndarray)):
        audio = np.asarray(audio)
    inference_kwargs = dict(model=model, audio=audio, verbose=verbose,
                            word_timestamps=word_timestamps,
                            progress_callback=progress_callback, **options)
    return transcribe_any(
        inference_func=_run_faster_whisper,
        audio=audio,
        inference_kwargs=inference_kwargs,
        # faster-whisper arrays must already be 16 kHz (fw's own contract)
        input_sr=16000 if isinstance(audio, np.ndarray) else None,
        model_sr=16000,
        verbose=verbose,
        regroup=regroup,
        suppress_silence=suppress_silence,
        suppress_word_ts=suppress_word_ts,
        q_levels=q_levels,
        k_size=k_size,
        denoiser=denoiser,
        denoiser_options=denoiser_options,
        vad=vad,
        vad_threshold=vad_threshold,
        min_word_dur=min_word_dur,
        min_silence_dur=min_silence_dur,
        nonspeech_error=nonspeech_error,
        use_word_position=use_word_position,
        only_voice_freq=only_voice_freq,
        force_order=True,
        check_sorted=check_sorted,
    )


def _run_faster_whisper(model, audio, verbose, progress_callback=None,
                        **fw_options):
    """Drive the fw generator and collect plain segment dicts."""
    if isinstance(audio, bytes):
        import io
        audio = io.BytesIO(audio)
    if 'batch_size' in fw_options:
        transcribe = model.batch_inference_pipeline.transcribe
    else:
        transcribe = getattr(model, 'transcribe_original', model.transcribe)
    segments, info = transcribe(audio, **fw_options)

    language = getattr(info, 'language', None)
    if verbose is not None:
        print(f'Detected Language: {language}')
    total_duration = round(getattr(info, 'duration', 0.0), 2)

    collected = []
    for segment in segments:
        seg = segment._asdict() if hasattr(segment, '_asdict') else dict(segment)
        words = seg.get('words')
        if words is None:
            seg.pop('words', None)
        else:
            seg['words'] = [w if isinstance(w, dict) else w._asdict()
                            for w in words]
        if verbose:
            safe_print(Segment(**seg, ignore_unused_args=True).to_display_str())
        collected.append(seg)
        if progress_callback is not None:
            progress_callback(min(seg['end'], total_duration) if total_duration
                              else seg['end'], total_duration)
    if progress_callback is not None and total_duration:
        progress_callback(total_duration, total_duration)
    return dict(language=language, segments=collected)


# -- align / refine inference funcs ---------------------------------------------------


def fw_alignment_func(model, tokenizer) -> Callable:
    """(audio_segment, word_tokens) -> word dicts via fw's own
    add_word_timestamps (reference alignment.py:482-507)."""
    def compute_timestamps(audio_segment: np.ndarray, word_tokens) -> List[dict]:
        audio_segment = np.asarray(audio_segment, np.float32)
        segment_samples = int(audio_segment.shape[-1])
        sr = model.feature_extractor.sampling_rate
        temp_segment = dict(
            seek=0, start=0.0,
            end=round(segment_samples / sr, 3),
            tokens=[t for wt in word_tokens for t in wt.tokens],
        )
        features = model.feature_extractor(audio_segment)
        encoder_output = model.encode(
            features[:, :model.feature_extractor.nb_max_frames])
        model.add_word_timestamps(
            segments=[[temp_segment]],
            tokenizer=getattr(tokenizer, '_t', tokenizer),
            encoder_output=encoder_output,
            num_frames=round(segment_samples
                             / model.feature_extractor.hop_length),
            prepend_punctuations='',
            append_punctuations='',
            last_speech_timestamp=temp_segment['start'],
        )
        return temp_segment['words']

    return compute_timestamps


def fw_refinement_func(model, tokenizer) -> Callable:
    """(audio[2, T], tokens) -> (2, n_tokens) realized-token probabilities
    via CTranslate2's align API (reference alignment.py:725-751)."""
    def one_row(row: np.ndarray, tokens: List[int]) -> List[float]:
        features = model.feature_extractor(np.asarray(row, np.float32))
        encoder_output = model.encode(
            features[:, :model.feature_extractor.nb_max_frames])
        num_frames = round(row.shape[-1] / model.feature_extractor.hop_length)
        return model.model.align(
            encoder_output, tokenizer.sot_sequence, [list(tokens)],
            num_frames, median_filter_width=1)[0].text_token_probs

    def inference_func(audio_segment: np.ndarray, tokens: List[int]) -> np.ndarray:
        return np.asarray([one_row(row, tokens) for row in audio_segment],
                          np.float64)

    return inference_func


# -- loader ----------------------------------------------------------------------------


def _deprecated_transcribe_stable(model, *args, **kwargs):
    warnings.warn('``model.transcribe_stable()`` is deprecated; use '
                  '``model.transcribe()`` (the original faster-whisper '
                  'transcribe is ``model.transcribe_original()``).')
    return model.transcribe(*args, **kwargs)


def load_faster_whisper(model_size_or_path: str, **model_init_options):
    """Load a ``faster_whisper.WhisperModel`` wired into this package:
    stabilized ``.transcribe()``, ``.batch_inference_pipeline``, and
    ``.align()/.align_words()/.refine()`` (reference faster_whisper.py:235)."""
    try:
        from faster_whisper import BatchedInferencePipeline, WhisperModel
    except ImportError as exc:  # pragma: no cover - exercised via fake module
        raise ImportError(_INSTALL_HINT) from exc

    fw_model = WhisperModel(model_size_or_path, **model_init_options)
    fw_model.model_size_or_path = model_size_or_path
    return modify_fw_model(fw_model, BatchedInferencePipeline)


def modify_fw_model(fw_model, batched_pipeline_cls=None):
    """Attach the stabilized method surface to an existing
    ``faster_whisper.WhisperModel`` (the patch half of the reference's
    ``load_faster_whisper``, faster_whisper.py:235; also reachable through
    the public ``modify_model`` in loaders.py)."""
    fw_model.transcribe_original = fw_model.transcribe
    fw_model.transcribe = MethodType(faster_transcribe, fw_model)
    fw_model.transcribe_stable = MethodType(_deprecated_transcribe_stable,
                                            fw_model)
    if batched_pipeline_cls is None:
        try:
            from faster_whisper import BatchedInferencePipeline
            batched_pipeline_cls = BatchedInferencePipeline
        except ImportError:
            batched_pipeline_cls = None
    try:
        fw_model.batch_inference_pipeline = (
            batched_pipeline_cls(fw_model) if batched_pipeline_cls else None)
    except Exception:  # older faster-whisper: batched pipeline optional
        fw_model.batch_inference_pipeline = None

    from ..alignment import align, align_words, refine
    fw_model.align = MethodType(align, fw_model)
    fw_model.align_words = MethodType(align_words, fw_model)
    fw_model.refine = MethodType(refine, fw_model)
    return fw_model
