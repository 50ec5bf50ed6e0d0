"""Transcription driver: the 30-second seek loop with stabilized timestamps
(port of stable_ts_tpu/transcribe.py:transcribe_stable).

The loop is host code and matches the JAX driver line for line; it touches
the device only through the model's methods (``embed_audio``, ``decode``),
:func:`~.ops.mel.log_mel_spectrogram` and
:func:`~.models.whisper.timing.add_word_timestamps`. Every window's mel is
computed on the model's device, encoded once, and reused by the decode and
the word-timing pass.
"""
import warnings
from typing import Callable, List, Optional, Union

import numpy as np

from stable_ts_tpu.audio.loader import AudioLoader
from stable_ts_tpu.constants import (N_FRAMES, N_SAMPLES, N_SAMPLES_PER_TOKEN,
                                     SAMPLE_RATE)
from stable_ts_tpu.defaults import (get_append_punctuations, get_min_word_dur,
                                    get_prepend_punctuations)
from stable_ts_tpu.result import Segment, WhisperResult
from stable_ts_tpu.stabilization import NonSpeechPredictor
from stable_ts_tpu.utils import (decode_acceptable, format_timestamp,
                                 keep_segment_instant_rule, make_progress_bar,
                                 progress_update, safe_print, timestamp_spans)

from .models.whisper.decoding import DecodingOptions, DecodingResult
from .models.whisper.timing import add_word_timestamps
from .ops.mel import log_mel_spectrogram


def _pad_or_trim_mask(mask: np.ndarray, length: int) -> np.ndarray:
    if mask.shape[-1] >= length:
        return mask[..., :length]
    return np.pad(mask, (0, length - mask.shape[-1]))


def transcribe_stable(
        model,
        audio,
        *,
        verbose: Optional[bool] = False,
        temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        word_timestamps: bool = True,
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
        vad_onnx: bool = False,
        min_word_dur: Optional[float] = None,
        min_silence_dur: Optional[float] = None,
        nonspeech_error: float = 0.1,
        only_voice_freq: bool = False,
        prepend_punctuations: Optional[str] = None,
        append_punctuations: Optional[str] = None,
        stream: Optional[bool] = None,
        mel_first: Optional[bool] = None,
        split_callback: Optional[Callable] = None,
        suppress_ts_tokens: bool = False,
        gap_padding: str = ' ...',
        only_ffmpeg: bool = False,
        max_instant_words: float = 0.5,
        avg_prob_threshold: Optional[float] = None,
        nonspeech_skip: Optional[float] = None,
        progress_callback: Optional[Callable] = None,
        ignore_compatibility: bool = False,
        extra_models: Optional[list] = None,
        suppress_attention: bool = False,
        time_scale: Optional[float] = None,
        ts_num: int = 0,
        ts_noise: Optional[float] = None,
        dynamic_heads=None,
        nonspeech_sections_holder: Optional[list] = None,
        clip_timestamps: Optional[Union[str, List[float]]] = None,
        resume: Optional[Union[str, WhisperResult]] = None,
        aligner: Union[str, dict] = 'legacy',
        demucs=None,
        demucs_options: Optional[dict] = None,
        **decode_options,
) -> WhisperResult:
    """Transcribe ``audio`` with stabilized word-level timestamps; the same
    parameters and behavior as stable_ts_tpu's ``transcribe_stable``."""
    if extra_models:
        raise NotImplementedError('extra_models are still to be ported to '
                                  'stable_ts_tpu_torch (ROADMAP.md)')
    if 'beam_size' in decode_options and decode_options['beam_size'] is None:
        decode_options.pop('beam_size')
    if suppress_attention:
        warnings.warn('``suppress_attention`` is deprecated and will be '
                      'removed in future versions', stacklevel=2)
    if time_scale:
        warnings.warn('``time_scale`` is deprecated and will be removed in '
                      'future versions. It currently does not affect '
                      'results.', stacklevel=2)
    if ts_num:
        warnings.warn('``ts_num`` is deprecated and will be removed in '
                      'future versions.', stacklevel=2)
    if ts_noise:
        warnings.warn('``ts_noise`` is deprecated and will be removed in '
                      'future versions.', stacklevel=2)
    min_word_dur = get_min_word_dur(min_word_dur)
    prepend_punctuations = get_prepend_punctuations(prepend_punctuations)
    append_punctuations = get_append_punctuations(append_punctuations)
    if isinstance(clip_timestamps, str):
        clip_timestamps = [float(t) for t in clip_timestamps.split(',') if t]
    load_sections = None
    if clip_timestamps:
        pairs = list(clip_timestamps) + ([None] if len(clip_timestamps) % 2 else [])
        load_sections = [(pairs[i], pairs[i + 1]) for i in range(0, len(pairs), 2)]

    from stable_ts_tpu.audio.denoiser import convert_demucs_kwargs
    denoiser, denoiser_options = convert_demucs_kwargs(
        denoiser, denoiser_options, demucs=demucs, demucs_options=demucs_options)
    denoiser_options = dict(denoiser_options)
    denoised_save_path = denoiser_options.pop('save_path', None)
    loader = audio if isinstance(audio, AudioLoader) else AudioLoader(
        audio,
        stream=stream,
        denoiser=denoiser,
        denoiser_options=denoiser_options,
        only_voice_freq=only_voice_freq,
        only_ffmpeg=only_ffmpeg,
        verbose=verbose,
        new_chunk_divisor=512 if vad else None,
        load_sections=load_sections,
        save_path=denoised_save_path,
    )

    task = decode_options.get('task', 'transcribe')
    if word_timestamps and task == 'translate':
        warnings.warn('Word-level timestamps on translations may not be reliable.')

    tokenizer = None
    language = None
    initial_prompt_tokens: List[int] = []
    all_tokens: List[int] = []
    all_segments: List[dict] = []
    prompt_reset_since = 0
    seek_sample = 0
    time_precision = 0.02

    nonspeech_predictor = NonSpeechPredictor(
        vad=vad if suppress_silence else None,
        mask_pad_func=_pad_or_trim_mask,
        get_mask=suppress_ts_tokens,
        min_word_dur=min_word_dur,
        q_levels=q_levels,
        k_size=k_size,
        vad_threshold=vad_threshold,
        vad_onnx=vad_onnx,
        vad_window=512,
        sampling_rate=SAMPLE_RATE,
        verbose=None if loader.stream else verbose,
        store_timings=True,
        min_silence_dur=min_silence_dur,
    )
    loader.update_post_prep_callback(
        nonspeech_predictor.get_on_prep_callback(loader.stream))

    punctuations = prepend_punctuations + append_punctuations

    def ensure_tokenizer(audio_features):
        nonlocal tokenizer, language, initial_prompt_tokens
        if tokenizer is not None:
            return
        if not decode_options.get('language'):
            if not model.is_multilingual:
                decode_options['language'] = 'en'
            else:
                langs, _ = model.detect_language(audio_features)
                decode_options['language'] = langs[0]
                if verbose is not None:
                    print(f'Detected language: {decode_options["language"]}')
        language = decode_options['language']
        tokenizer = model.get_tokenizer(language=language, task=task)
        if initial_prompt is not None:
            initial_prompt_tokens = tokenizer.encode(' ' + initial_prompt.strip())
            all_tokens.extend(initial_prompt_tokens)

    def decode_with_fallback(audio_features, ts_token_mask=None) -> DecodingResult:
        # one encoder pass per window; every rung decodes from its features
        temperatures = ([temperature] if isinstance(temperature, (int, float))
                        else list(temperature))
        decode_result = None
        for t in temperatures:
            kwargs = {k: v for k, v in decode_options.items()
                      if k not in ('task', 'language')}
            if t > 0:
                kwargs.pop('beam_size', None)
                kwargs.pop('patience', None)
            else:
                kwargs.pop('best_of', None)
            options = DecodingOptions(
                task=task, language=decode_options.get('language'),
                temperature=t, **kwargs)
            decode_result = model.decode(
                audio_features, options,
                ts_silence_mask=ts_token_mask if suppress_ts_tokens else None)[0]
            if decode_acceptable(decode_result, compression_ratio_threshold,
                                 logprob_threshold, no_speech_threshold):
                break
        return decode_result

    def new_segment(*, start, end, tokens, result: DecodingResult):
        tokens = [int(t) for t in tokens]
        text_tokens = [t for t in tokens if t < tokenizer.eot]
        return {
            'seek': round(seek_sample / SAMPLE_RATE, 3),
            'start': start,
            'end': end,
            'text': tokenizer.decode(text_tokens),
            'tokens': tokens,
            'temperature': result.temperature,
            'avg_logprob': result.avg_logprob,
            'compression_ratio': result.compression_ratio,
            'no_speech_prob': result.no_speech_prob,
        }

    # -- resume ----------------------------------------------------------------
    if resume is not None:
        remove_last_seg = False
        if not isinstance(resume, WhisperResult):
            if isinstance(resume, str) and resume.endswith('+'):
                resume = resume[:-1]
                remove_last_seg = True
            resume = WhisperResult(resume)
        if len(resume.segments) and remove_last_seg:
            del resume[-1]
            resume.unfinished_start = -1.0
        if resume.unfinished_start == -1.0:
            resume_start = resume[-1].end if len(resume.segments) else 0.0
        else:
            resume_start = resume.unfinished_start
        seek_sample = round(resume_start * SAMPLE_RATE)
        if verbose is not None:
            print(f'Resuming from {format_timestamp(resume_start)}')
        decode_options['language'] = resume.language

    interrupted_time = -1.0
    total_duration = loader.get_duration(2)
    pbar = make_progress_bar(total_duration, task.title(), verbose)

    def report_progress():
        progress_update(pbar, seek_sample / SAMPLE_RATE)
        if progress_callback is not None:
            progress_callback(min(total_duration, seek_sample / SAMPLE_RATE),
                              total_duration)

    # -- the seek loop --------------------------------------------------------------
    def inner_transcribe():
        nonlocal seek_sample, prompt_reset_since
        audio_segment, new_seek = loader.next_valid_chunk(seek_sample, N_SAMPLES)
        if audio_segment is None:
            return 1
        if new_seek != seek_sample:
            seek_sample = new_seek
        time_offset = seek_sample / SAMPLE_RATE
        segment_samples = audio_segment.shape[-1]
        segment_duration = segment_samples / SAMPLE_RATE

        silence_preds = nonspeech_predictor.predict(audio_segment, offset=time_offset)
        segment_silence_timing = silence_preds['timings'] if suppress_silence else None
        ts_token_mask = silence_preds['mask'] if suppress_ts_tokens else None

        if silence_preds['is_silent']:
            seek_sample += segment_samples
            report_progress()
            return

        if nonspeech_skip and silence_preds['timings'] is not None:
            sil_starts = silence_preds['timings'][0] - time_offset
            sil_ends = silence_preds['timings'][1] - time_offset
            long_idx = np.flatnonzero((sil_ends - sil_starts) >= nonspeech_skip)
            if len(long_idx):
                idx = long_idx[0]
                if (sil_starts[idx] < min_word_dur
                        or int(sil_starts[idx] * SAMPLE_RATE) == 0):
                    seek_sample += round(sil_ends[idx] * SAMPLE_RATE)
                    report_progress()
                    return
                audio_segment = audio_segment[..., :int(sil_starts[idx] * SAMPLE_RATE)]
                segment_samples = audio_segment.shape[-1]
                segment_duration = segment_samples / SAMPLE_RATE

        sample_padding = max(N_SAMPLES - segment_samples, 0)
        mel_segment = log_mel_spectrogram(audio_segment, model.dims.n_mels,
                                          padding=sample_padding,
                                          device=model.device)[..., :N_FRAMES]

        # ONE encoder pass per window: every fallback rung and the word-timing
        # pass below reuse these features
        audio_features = model.embed_audio(mel_segment)
        ensure_tokenizer(audio_features)
        prompt = all_tokens[prompt_reset_since:]
        decode_options['prompt'] = prompt if prompt else None
        result = decode_with_fallback(audio_features, ts_token_mask=ts_token_mask)
        tokens = np.array(result.tokens)

        if no_speech_threshold is not None:
            should_skip = result.no_speech_prob > no_speech_threshold
            if (logprob_threshold is not None
                    and result.avg_logprob > logprob_threshold):
                should_skip = False
            if should_skip:
                seek_sample += segment_samples
                report_progress()
                return

        ts_begin = tokenizer.timestamp_begin
        spans, end_timestamp_pos, single_timestamp_ending = \
            timestamp_spans(tokens, ts_begin)
        if spans:
            current_segments = [
                new_segment(
                    start=round(time_offset
                                + (int(sp[0]) - ts_begin) * time_precision, 3),
                    end=round(time_offset
                              + min((int(sp[-1]) - ts_begin) * time_precision,
                                    segment_duration), 3),
                    tokens=sp, result=result)
                for sp in spans]
        else:
            duration = (min(end_timestamp_pos * time_precision,
                            segment_duration)
                        if end_timestamp_pos > 0 else segment_duration)
            current_segments = [new_segment(
                start=round(time_offset, 3),
                end=round(time_offset + duration, 3),
                tokens=tokens, result=result)]

        # prune punctuation-only / zero-span segments
        for i in reversed(range(len(current_segments))):
            seg = current_segments[i]
            if seg['text'].strip() in punctuations:
                del current_segments[i]
            elif word_timestamps:
                if seg['start'] == seg['end']:
                    del current_segments[i]
            else:
                nxt = i + 1
                max_end = (seg['end'] if nxt >= len(current_segments)
                           else current_segments[nxt]['start'])
                if seg['start'] > seg['end']:
                    prev_ok = (i != 0 and current_segments[i - 1]['end']
                               != current_segments[i - 1]['start']
                               and current_segments[i - 1]['end'] < max_end)
                    seg['start'] = current_segments[i - 1]['end'] if prev_ok else max_end

        num_samples = (min(round(end_timestamp_pos * N_SAMPLES_PER_TOKEN),
                           segment_samples)
                       if end_timestamp_pos > 0 else segment_samples)

        if word_timestamps:
            add_word_timestamps(
                segments=current_segments,
                model=model.params,
                dims=model.dims,
                tokenizer=tokenizer,
                mel=mel_segment,
                num_samples=num_samples,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                audio_features=(result.audio_features[None]
                                if result.audio_features is not None else None),
                min_word_dur=min_word_dur,
                split_callback=split_callback,
                gap_padding=gap_padding,
                alignment_heads=model.alignment_heads,
                dynamic_heads=dynamic_heads,
                aligner=aligner,
            )
            for i in reversed(range(len(current_segments))):
                if not keep_segment_instant_rule(
                        current_segments[i]['words'], max_instant_words):
                    del current_segments[i]
            if avg_prob_threshold and current_segments:
                all_probs = [w['probability'] for s in current_segments
                             for w in s['words']]
                if single_timestamp_ending and np.mean(all_probs) < avg_prob_threshold:
                    num_samples = segment_samples
                    current_segments = []
                else:
                    num_samples = round(
                        (current_segments[-1]['words'][-1]['end'] - time_offset)
                        * SAMPLE_RATE)

        if len(current_segments) == 0:
            seek_sample += segment_samples
            report_progress()
            return

        all_tokens.extend(t for segment in current_segments
                          for t in segment['tokens'])

        if segment_silence_timing is not None:
            for seg_i, segment in enumerate(current_segments):
                seg_obj = Segment(**segment, ignore_unused_args=True).suppress_silence(
                    *segment_silence_timing,
                    min_word_dur=min_word_dur,
                    word_level=suppress_word_ts,
                    nonspeech_error=nonspeech_error,
                    use_word_position=use_word_position,
                )
                if verbose:
                    safe_print(seg_obj.to_display_str())
                current_segments[seg_i] = seg_obj.to_dict()

        all_segments.extend(
            {'id': i, **segment}
            for i, segment in enumerate(current_segments, start=len(all_segments)))

        if not single_timestamp_ending or avg_prob_threshold:
            seek_sample += num_samples
        else:
            seek_sample += segment_samples

        if not condition_on_previous_text or result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)
        report_progress()

    try:
        while True:
            try:
                if inner_transcribe() is not None:
                    break
            except KeyboardInterrupt:
                if all_segments:
                    interrupted_time = all_segments[-1]['end']
                curr_seek_time = seek_sample / SAMPLE_RATE
                if curr_seek_time > interrupted_time:
                    interrupted_time = curr_seek_time
                pbar.write(f'Interrupted at {format_timestamp(curr_seek_time)}')
                break
        if interrupted_time == -1.0:
            progress_update(pbar, seek_sample / SAMPLE_RATE)
    finally:
        pbar.close()

    loader.terminate()
    nonspeech_predictor.finalize_timings()

    text = '' if tokenizer is None else tokenizer.decode(
        all_tokens[len(initial_prompt_tokens):])
    final_result = WhisperResult(
        dict(text=text, segments=all_segments, language=language),
        force_order=not word_timestamps,
    )

    final_nonspeech_timings = (nonspeech_predictor.nonspeech_timings
                               if suppress_silence else None)

    if resume is not None:
        if len(resume.segments):
            if len(final_result.segments):
                if resume.has_words:
                    resume.fill_in_gaps(final_result, verbose=False)
                else:
                    max_resume_end = final_result[0].start
                    while len(resume.segments) and resume[-1].end > max_resume_end:
                        del resume[-1]
                    resume.segments.extend(final_result.segments)
                    resume.reassign_ids()
            if final_nonspeech_timings:
                resume.update_nonspeech_sections(*final_nonspeech_timings,
                                                 overwrite=False)
            final_result = resume
        else:
            ns_starts = [s['start'] for s in resume.nonspeech_sections]
            ns_ends = [s['end'] for s in resume.nonspeech_sections]
            if final_nonspeech_timings:
                ns_starts.extend(final_nonspeech_timings[0])
                ns_ends.extend(final_nonspeech_timings[1])
            final_result.update_nonspeech_sections(ns_starts, ns_ends)
    elif final_nonspeech_timings:
        final_result.update_nonspeech_sections(*final_nonspeech_timings)

    if word_timestamps and regroup:
        final_result.regroup(regroup)

    final_result.unfinished_start = interrupted_time

    if len(final_result.text) == 0:
        warnings.warn(f'Failed to {task} audio. Result contains no text.')

    return final_result
