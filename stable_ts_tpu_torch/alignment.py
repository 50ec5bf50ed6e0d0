"""Whisper glue for ``align`` and ``align_words`` (port of
stable_ts_tpu/alignment.py:1-462).

Both build the engine-agnostic :class:`~.non_whisper.alignment.Aligner`
around inference functions that run the model: mel -> encoder ->
teacher-forced capture pass -> head weights -> DTW. With the legacy
aligner and known heads, one window's pass is
:func:`~.models.whisper.timing._fused_align_window` (the capture narrowed
to the alignment heads, one download of the DTW cost and the token
probabilities); otherwise it goes through ``add_word_timestamps``, as
``transcribe`` does. ``align_words(parallel=True)`` runs one encoder pass
and one capture pass over every segment at once, then one batched head
weighting and one DTW launch for all of them (known heads), or
``add_word_timestamps(precomputed=...)`` a segment at a time.

``refine`` and ``locate`` are still to be ported (ROADMAP.md).
"""
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .constants import (N_FFT, N_FRAMES, N_SAMPLES, N_SAMPLES_PER_TOKEN,
                        SAMPLE_RATE, TOKENS_PER_SECOND)
from .loaders import is_faster_whisper_model
from .non_whisper.alignment import Aligner, WordToken
from .ops.mel import log_mel_spectrogram
from .options import AllOptions
from .profiling import traced
from .result import WhisperResult

__all__ = ['align', 'align_words']


def _refuse_faster_whisper(model):
    if is_faster_whisper_model(model):
        raise NotImplementedError('faster-whisper models are still to be '
                                  'ported to stable_ts_tpu_torch (ROADMAP.md)')


def _pad_mel(mel: torch.Tensor) -> torch.Tensor:
    """Pad/trim mel frames to exactly N_FRAMES."""
    if mel.shape[-1] >= N_FRAMES:
        return mel[..., :N_FRAMES]
    return torch.nn.functional.pad(mel, (0, N_FRAMES - mel.shape[-1]))


def _resolve_tokenizer(model, text, language: Optional[str]):
    if language is None:
        language = getattr(text, 'language', None)
    if language is None:
        if model.is_multilingual:
            raise TypeError('expected argument for language')
        language = 'en'
    return model.get_tokenizer(language=language, task='transcribe')


def _legacy_known_heads(model, options: AllOptions) -> bool:
    """True when the default timing mode applies: legacy aligner with the
    model's canonical alignment heads and no dynamic selection, the mode
    whose capture can be narrowed to the alignment heads on the device."""
    aligner = options.align.aligner
    return (aligner == 'legacy' and not isinstance(aligner, dict)
            and model.alignment_heads is not None
            and not options.align.dynamic_heads)


def _fused_single_window_func(model, tokenizer) -> Callable:
    """(audio_segment, word_tokens) -> word dicts through
    :func:`~.models.whisper.timing._fused_align_window`. Token rows bucket
    to 32, as in the JAX package (where the bucket bounds the compile
    set)."""
    from .models.whisper.timing import (_fused_align_window,
                                        build_head_capture_table)

    capture_index, slots = build_head_capture_table(
        model.alignment_heads, model.dims.n_text_layer)
    sot_seq = list(tokenizer.sot_sequence)
    sot_len = len(sot_seq)

    def compute_timestamps(audio_segment: np.ndarray,
                           word_tokens: List[WordToken]) -> List[dict]:
        word_tokens_l = [wt.tokens for wt in word_tokens]
        text_tokens = [t for toks in word_tokens_l for t in toks]
        segment_samples = int(np.asarray(audio_segment).shape[-1])
        audio = np.zeros((1, N_SAMPLES), np.float32)
        n_real = min(segment_samples, N_SAMPLES)
        audio[0, :n_real] = audio_segment[..., :n_real]
        row = sot_seq + [tokenizer.no_timestamps] + text_tokens \
            + [tokenizer.eot]
        t_pad = max(32, -(-len(row) // 32) * 32)
        tokens = np.full((1, t_pad), tokenizer.eot, np.int64)
        tokens[0, :len(row)] = row
        n_text = len(text_tokens)
        qk_len = round(min(segment_samples, N_SAMPLES) / N_SAMPLES_PER_TOKEN)
        packed = _fused_align_window(
            model.params, capture_index, slots,
            torch.from_numpy(audio).to(model.device),
            torch.from_numpy(tokens).to(model.device),
            max(qk_len, 1), n_text + 1, n_mels=model.dims.n_mels,
            sot_len=sot_len, eot=tokenizer.eot)
        t_rows = t_pad - sot_len - 1
        jump_times = packed[:t_rows] / TOKENS_PER_SECOND
        probs = packed[t_rows:]
        text_token_probs = probs[sot_len:sot_len + n_text]

        return _assemble_word_dicts(word_tokens, word_tokens_l, jump_times,
                                    text_token_probs, tokenizer)

    return compute_timestamps


def _assemble_word_dicts(word_tokens, word_tokens_l, jump_times,
                         text_token_probs, tokenizer) -> List[dict]:
    """Host word assembly shared by the fused single-window and batched
    align paths: the structure add_word_timestamps produces with this
    path's arguments (no gap padding entries exist, and the empty
    punctuation sets make merge_punctuations a no-op)."""
    from .models.whisper.timing import WordTimingRaw, merge_punctuations
    words = [wt.word for wt in word_tokens] \
        + [tokenizer.decode([tokenizer.eot])]
    wts = list(word_tokens_l) + [[tokenizer.eot]]
    bounds = np.pad(np.cumsum([len(t) for t in wts[:-1]]), (1, 0))
    starts, ends = jump_times[bounds[:-1]], jump_times[bounds[1:]]
    word_probs = [float(np.mean(text_token_probs[a:b]))
                  for a, b in zip(bounds[:-1], bounds[1:])]
    alignment = [WordTimingRaw(w, tk, float(s), float(e), p)
                 for w, tk, s, e, p in zip(words, wts, starts, ends,
                                           word_probs)]
    merge_punctuations(alignment, '', '')
    return [dict(word=t.word, start=round(t.start, 3),
                 end=round(t.end, 3), probability=t.probability,
                 tokens=t.tokens)
            for t in alignment[:len(word_tokens)] if len(t.tokens)]


def _whisper_alignment_func(model, tokenizer, options: AllOptions) -> Callable:
    """(audio_segment, word_tokens) -> word timing dicts through the
    model."""
    if _legacy_known_heads(model, options):
        return _fused_single_window_func(model, tokenizer)
    from .models.whisper.timing import add_word_timestamps

    def compute_timestamps(audio_segment: np.ndarray,
                           word_tokens: List[WordToken]) -> List[dict]:
        curr_words = [wt.word for wt in word_tokens]
        curr_word_tokens = [wt.tokens for wt in word_tokens]
        temp_segments = [dict(seek=0, tokens=(curr_words, curr_word_tokens))]
        segment_samples = int(audio_segment.shape[-1])
        sample_padding = max(N_SAMPLES - segment_samples, 0)
        mel_segment = _pad_mel(log_mel_spectrogram(
            audio_segment, model.dims.n_mels, padding=sample_padding,
            device=model.device))
        add_word_timestamps(
            segments=temp_segments,
            model=model.params,
            dims=model.dims,
            tokenizer=tokenizer,
            mel=mel_segment,
            num_samples=segment_samples,
            split_callback=(lambda x, _: x),
            prepend_punctuations='',
            append_punctuations='',
            gap_padding=None,
            alignment_heads=model.alignment_heads,
            dynamic_heads=options.align.dynamic_heads,
            aligner=options.align.aligner,
        )
        return [w for seg in temp_segments for w in seg['words']]

    return compute_timestamps


def _whisper_alignment_batch_func(model, tokenizer, options: AllOptions) -> Callable:
    """list[(audio_segment, word_tokens)] -> list[word timing dicts].

    One upload of the segments' audio, their mels on the device, and one
    encoder pass and one teacher-forced capture pass for EVERY segment
    (right-padded token rows are exact under the causal mask). With known
    heads the capture is narrowed to them and one batched head weighting,
    one DTW launch and one download serve every segment; otherwise the
    capture is downloaded and each segment goes through
    ``add_word_timestamps(precomputed=...)``, the sequential path's host
    logic. The JAX package shards the rows over its mesh here
    (``model.shard_batch``); the port has no mesh yet (ROADMAP.md), so the
    rows go in as they are."""
    from .batched import _dtw_cost_batched, _next_token_probs
    from .models.whisper.model import decoder_apply, encoder_apply
    from .models.whisper.timing import (add_word_timestamps,
                                        build_head_capture_table,
                                        legacy_weights_batched)
    from .ops.dtw import dtw_jumps_batched
    from .ops.mel import log_mel_windowed

    sot_seq = list(tokenizer.sot_sequence)
    sot_len = len(sot_seq)
    capture_index = capture_slots = None
    if _legacy_known_heads(model, options):
        capture_index, capture_slots = build_head_capture_table(
            model.alignment_heads, model.dims.n_text_layer)

    @torch.inference_mode()
    def batch_func(requests):
        audios, rows, metas = [], [], []
        for audio_segment, word_tokens in requests:
            text_tokens = [t for wt in word_tokens for t in wt.tokens]
            a = np.asarray(audio_segment, np.float32)
            audios.append(a)
            rows.append(sot_seq + [tokenizer.no_timestamps]
                        + list(text_tokens) + [tokenizer.eot])
            metas.append((word_tokens, text_tokens, int(a.shape[-1])))
        # the segments go up at their real (bucketed) length and
        # log_mel_windowed fills the zero-pad tail of each 30-s window
        # from the row max, equal to padding each row first
        t_max = max(a.shape[-1] for a in audios) + N_FFT
        t_bucket = max(SAMPLE_RATE,
                       -(-t_max // SAMPLE_RATE) * SAMPLE_RATE)
        pad_rows = 1 << max(2, int(np.ceil(np.log2(len(audios)))))
        audio_batch = np.zeros((pad_rows, t_bucket), np.float32)
        for i, a in enumerate(audios):
            audio_batch[i, :a.shape[-1]] = a[:t_bucket]
        max_len = max(32, int(np.ceil(max(len(r) for r in rows) / 32) * 32))
        tok_batch = np.full((pad_rows, max_len), tokenizer.eot, np.int64)
        for i, row in enumerate(rows):
            tok_batch[i, :len(row)] = row

        device = model.device
        audio_in = torch.from_numpy(audio_batch).to(device)
        tokens_in = torch.from_numpy(tok_batch).to(device)
        mel_batch = log_mel_windowed(audio_in, model.dims.n_mels, N_FRAMES)
        xa = encoder_apply(model.params.encoder, mel_batch)
        logits, qks = decoder_apply(model.params.decoder, tokens_in, xa,
                                    capture_qk=True,
                                    capture_index=capture_index)
        # the realized next tokens' probabilities, gathered on the device
        tok_probs_dev = _next_token_probs(logits, tokens_in, tokenizer.eot)
        del logits, xa
        if capture_slots is not None:
            # known heads: head weights, the DTW cost and one download for
            # every segment at once; the traceback on the host
            layers = torch.tensor([l for l, _ in capture_slots], device=device)
            cols = torch.tensor([s for _, s in capture_slots], device=device)
            sel = qks[layers, :, cols]                  # (n_sel, B, T, 1500)
            pad_b = sel.shape[1]
            qk_lens = [round(min(samples, N_SAMPLES) / N_SAMPLES_PER_TOKEN)
                       or 1 for _, _, samples in metas]
            row_counts = [len(text_tokens) + 1
                          for _, text_tokens, _ in metas]
            qk_lens_in = torch.tensor(
                qk_lens + [1] * (pad_b - len(metas)), device=device)
            rows_in = torch.tensor(
                row_counts + [1] * (pad_b - len(metas)), device=device)
            mats = legacy_weights_batched(sel, qk_lens_in, rows_in, sot_len,
                                          1.0, 7)
            cost = _dtw_cost_batched(-mats)[:len(metas)].cpu().numpy()
            jumps = dtw_jumps_batched(cost, row_counts, qk_lens)
            tok_probs = tok_probs_dev.cpu().numpy()
            outputs = []
            for i, (word_tokens, text_tokens, _) in enumerate(metas):
                n_text = len(text_tokens)
                jump_times = jumps[i, :row_counts[i]] / TOKENS_PER_SECOND
                probs = tok_probs[i, sot_len:sot_len + n_text]
                outputs.append(_assemble_word_dicts(
                    word_tokens, [wt.tokens for wt in word_tokens],
                    jump_times, probs, tokenizer))
            return outputs

        qks_host = qks.cpu()        # dynamic / 'new': needs every head
        del qks
        tok_probs = tok_probs_dev.cpu().numpy()
        outputs = []
        for i, (word_tokens, text_tokens, segment_samples) in enumerate(metas):
            n_text = len(text_tokens)
            t_keep = sot_len + 1 + n_text + 1
            qks_i = qks_host[:, i, :, :t_keep]
            text_token_probs = tok_probs[i, sot_len:sot_len + n_text].tolist()
            curr_words = [wt.word for wt in word_tokens]
            curr_word_tokens = [wt.tokens for wt in word_tokens]
            temp_segments = [dict(seek=0,
                                  tokens=(curr_words, curr_word_tokens))]
            add_word_timestamps(
                segments=temp_segments,
                model=model.params,
                dims=model.dims,
                tokenizer=tokenizer,
                mel=None,
                num_samples=segment_samples,
                split_callback=(lambda x, _: x),
                prepend_punctuations='',
                append_punctuations='',
                gap_padding=None,
                alignment_heads=model.alignment_heads,
                dynamic_heads=options.align.dynamic_heads,
                aligner=options.align.aligner,
                precomputed=(qks_i, text_token_probs),
            )
            outputs.append([w for seg in temp_segments for w in seg['words']])
        return outputs

    return batch_func


@traced('align')
def align(
        model,
        audio,
        text: Union[str, List[int], WhisperResult],
        language: Optional[str] = None,
        *,
        tokenizer=None,
        ignore_compatibility: bool = False,
        remove_instant_words: bool = False,
        token_step: int = 100,
        original_split: bool = False,
        word_dur_factor: Optional[float] = 2.0,
        max_word_dur: Optional[float] = 3.0,
        nonspeech_skip: Optional[float] = 5.0,
        fast_mode: bool = False,
        failure_threshold: Optional[float] = None,
        **options,
) -> Optional[WhisperResult]:
    """Align plain text (or a prior result) to audio at word level."""
    _refuse_faster_whisper(model)
    if tokenizer is None:
        tokenizer = _resolve_tokenizer(model, text, language)
    all_options = AllOptions(options, vanilla_align=True)
    n_text_ctx = model.dims.n_text_ctx if hasattr(model, 'dims') else 448
    max_token_step = n_text_ctx - 6
    if token_step < 1:
        token_step = max_token_step
    elif token_step > max_token_step:
        raise ValueError(f'The max value for [token_step] is {max_token_step} '
                         f'but got {token_step}.')

    aligner = Aligner(
        inference_func=_whisper_alignment_func(model, tokenizer, all_options),
        decode=tokenizer.decode,
        encode=tokenizer.encode,
        split_words_by_space=(getattr(tokenizer, 'language', 'en')
                              not in {'zh', 'ja', 'th', 'lo', 'my', 'yue'}),
        sample_rate=SAMPLE_RATE,
        max_segment_length=N_SAMPLES,
        remove_instant_words=remove_instant_words,
        token_step=token_step,
        original_split=original_split,
        word_dur_factor=word_dur_factor,
        max_word_dur=max_word_dur,
        nonspeech_skip=nonspeech_skip,
        fast_mode=fast_mode,
        failure_threshold=failure_threshold,
        all_options=all_options,
    )
    result = aligner.align(audio, text)
    if result is not None:
        result.language = getattr(tokenizer, 'language', language)
    return result


@traced('align_words')
def align_words(
        model,
        audio,
        result: Union[WhisperResult, List[dict]],
        language: Optional[str] = None,
        *,
        tokenizer=None,
        inplace: bool = True,
        normalize_text: bool = True,
        parallel: Optional[bool] = None,
        ignore_compatibility: bool = False,  # reference surface; no torch-
                                             # whisper version check applies
        **options,
) -> WhisperResult:
    """Confined per-segment alignment using each segment's start/end.

    ``parallel`` (default: on when the model's weights lie on a CUDA
    device) computes every segment's timing pass in one batched pass;
    segments are independent here, so the words equal the sequential
    path's.
    """
    _refuse_faster_whisper(model)
    if tokenizer is None:
        tokenizer = _resolve_tokenizer(model, result, language)
    if parallel is None:
        parallel = model.device.type == 'cuda'
    all_options = AllOptions(options, vanilla_align=True)
    aligner = Aligner(
        inference_func=_whisper_alignment_func(model, tokenizer, all_options),
        batch_inference_func=(
            _whisper_alignment_batch_func(model, tokenizer, all_options)
            if parallel else None),
        decode=tokenizer.decode,
        encode=tokenizer.encode,
        split_words_by_space=(getattr(tokenizer, 'language', 'en')
                              not in {'zh', 'ja', 'th', 'lo', 'my', 'yue'}),
        sample_rate=SAMPLE_RATE,
        max_segment_length=N_SAMPLES,
        all_options=all_options,
    )
    new_result = aligner.align_words(audio, result, normalize_text, inplace)
    new_result.language = getattr(tokenizer, 'language', language)
    return new_result
