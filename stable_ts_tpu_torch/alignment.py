"""Whisper glue for ``align``, ``align_words``, ``refine`` and ``locate``
(port of stable_ts_tpu/alignment.py).

``align`` and ``align_words`` build the engine-agnostic
:class:`~.non_whisper.alignment.Aligner` around inference functions that
run the model: mel -> encoder -> teacher-forced capture pass -> head
weights -> DTW. With the legacy aligner and known heads, the capture,
weights and DTW cost are
:func:`~.models.whisper.timing.known_heads_pass` (the capture narrowed to
the alignment heads), one window at a time through
:func:`~.models.whisper.timing._fused_align_window` (one download of the
DTW cost and the token probabilities), and the words come from
``words_from_jumps`` and ``attach_words``; otherwise a window goes
through ``add_word_timestamps``, as ``transcribe`` does.
``align_words(parallel=True)`` runs one encoder pass and one capture pass
over every segment at once: with known heads one ``known_heads_pass`` for
all of them, else ``add_word_timestamps(precomputed=...)`` a segment at a
time.

``refine`` builds the engine-agnostic
:class:`~.non_whisper.refinement.Refiner` around the teacher-forced
probability of each text token with parts of the audio muted. With
``parallel``, every span's bisection round is one batched pass whose
muted rows are rebuilt on the device from the span's clean audio and the
rows' mute intervals; a round is launched without waiting for the device
and collected with one download, so two span groups overlap. ``locate``
estimates where a text ends from the cross-attention of its last token
(one encoder and capture pass a 30-s chunk, the next chunk's launched
ahead), then confirms it with a greedy decode over a float self cache, one
``decoder_step`` a token.
"""
import os
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .constants import (CHUNK_LENGTH, FRAMES_PER_SECOND, HOP_LENGTH, N_FFT,
                        N_FRAMES, N_SAMPLES, N_SAMPLES_PER_TOKEN, SAMPLE_RATE)
from .backends.faster_whisper import (fw_alignment_func, fw_refinement_func,
                                      fw_tokenizer, is_faster_whisper_model)
from .models.whisper.model import decoder_apply, decoder_step, encoder_apply
from .models.whisper.timing import (_fused_align_window, _next_token_probs,
                                    _next_token_probs_and_ranks,
                                    add_word_timestamps, attach_words,
                                    build_head_capture_table, known_heads_pass,
                                    split_word_tokens, words_from_jumps)
from .non_whisper.alignment import Aligner, WordToken
from .non_whisper.refinement import MutedSpanProbe, Refiner
from .ops.dtw import dtw_jumps_batched
from .ops.median import median_filter
from .ops.mel import log_mel_spectrogram, log_mel_windowed
from .options import AllOptions
from .profiling import traced
from .result import Segment, WhisperResult
from .utils import format_timestamp, safe_print

__all__ = ['align', 'align_words', 'refine', 'locate']


def _pad_mel(mel: torch.Tensor) -> torch.Tensor:
    """Pad/trim mel frames to exactly N_FRAMES."""
    if mel.shape[-1] >= N_FRAMES:
        return mel[..., :N_FRAMES]
    return torch.nn.functional.pad(mel, (0, N_FRAMES - mel.shape[-1]))


def _resolve_tokenizer(model, text, language: Optional[str]):
    if language is None:
        language = getattr(text, 'language', None)
    if is_faster_whisper_model(model):
        return fw_tokenizer(model, language)
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
    capture_index, slots = build_head_capture_table(
        model.alignment_heads, model.dims.n_text_layer)
    slots = torch.as_tensor(slots, device=model.device)
    sot_seq = list(tokenizer.sot_sequence)
    sot_len = len(sot_seq)

    def compute_timestamps(audio_segment: np.ndarray,
                           word_tokens: List[WordToken]) -> List[dict]:
        text_tokens = [t for wt in word_tokens for t in wt.tokens]
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
        jumps, probs = _fused_align_window(
            model.params, capture_index, slots,
            torch.from_numpy(audio).to(model.device),
            torch.from_numpy(tokens).to(model.device),
            max(qk_len, 1), n_text + 1, n_mels=model.dims.n_mels,
            sot_len=sot_len, eot=tokenizer.eot)
        return _segment_words(word_tokens, jumps,
                              probs[sot_len:sot_len + n_text])

    return compute_timestamps


def _segment_words(word_tokens: List[WordToken], jump_indices,
                   text_token_probs) -> List[dict]:
    """One segment's word dicts as ``add_word_timestamps`` makes them with
    align's arguments: no gap padding, no punctuation to merge, offset 0."""
    alignment = words_from_jumps([wt.word for wt in word_tokens],
                                 [wt.tokens for wt in word_tokens],
                                 jump_indices, text_token_probs)
    segment = dict(words=[])
    attach_words([segment], alignment, [0] * len(alignment), 0.0, 0.0, '', '')
    return segment['words']


def _whisper_alignment_func(model, tokenizer, options: AllOptions) -> Callable:
    """(audio_segment, word_tokens) -> word timing dicts through the
    model (or the backend's own word-timing API for adapter models)."""
    if is_faster_whisper_model(model):
        return fw_alignment_func(model, tokenizer)
    if _legacy_known_heads(model, options):
        return _fused_single_window_func(model, tokenizer)

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
    logic. On a mesh each rank takes its rows (``model.shard_batch``, as
    the JAX package does here) and the token probabilities, the DTW costs
    or the capture are gathered over dp before they go to the host."""
    sot_seq = list(tokenizer.sot_sequence)
    sot_len = len(sot_seq)
    capture_index = capture_slots = None
    if _legacy_known_heads(model, options):
        capture_index, capture_slots = build_head_capture_table(
            model.alignment_heads, model.dims.n_text_layer)
        capture_slots = torch.as_tensor(capture_slots, device=model.device)

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

        # dp-split on a mesh (segments are independent); every consumer
        # below indexes < len(metas) of the gathered rows
        audio_in, _ = model.shard_batch(audio_batch)
        tokens_in, _ = model.shard_batch(tok_batch)
        mel_batch = log_mel_windowed(audio_in, model.dims.n_mels, N_FRAMES)
        if capture_slots is not None:
            # known heads: head weights, the DTW cost and one download for
            # every segment at once; the traceback on the host
            qk_lens = [round(min(samples, N_SAMPLES) / N_SAMPLES_PER_TOKEN)
                       or 1 for _, _, samples in metas]
            row_counts = [len(text_tokens) + 1
                          for _, text_tokens, _ in metas]
            qk_lens_in, _ = model.shard_batch(np.asarray(
                qk_lens + [1] * (pad_rows - len(metas))))
            rows_in, _ = model.shard_batch(np.asarray(
                row_counts + [1] * (pad_rows - len(metas))))
            tok_probs, cost = known_heads_pass(
                model.params.decoder, tokens_in,
                encoder_apply(model.params.encoder, mel_batch), capture_index,
                capture_slots, qk_lens_in, rows_in, sot_len, tokenizer.eot)
            cost = model.gather_batch(cost)[:len(metas)].cpu().numpy()
            jumps = dtw_jumps_batched(cost, row_counts, qk_lens)
            tok_probs = model.gather_batch(tok_probs).cpu().numpy()
            return [_segment_words(wts, jumps[i, :row_counts[i]],
                                   tok_probs[i, sot_len:sot_len + len(text)])
                    for i, (wts, text, _) in enumerate(metas)]

        # dynamic / 'new': needs every head
        xa = encoder_apply(model.params.encoder, mel_batch)
        logits, qks = decoder_apply(model.params.decoder, tokens_in, xa,
                                    capture_qk=True)
        # the realized next tokens' probabilities, gathered on the device
        tok_probs_dev = _next_token_probs(logits, tokens_in, tokenizer.eot)
        del logits, xa
        qks_host = model.gather_batch(qks, dim=1).cpu()
        del qks
        tok_probs = model.gather_batch(tok_probs_dev).cpu().numpy()
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
    if tokenizer is None:
        tokenizer = _resolve_tokenizer(model, result, language)
    if is_faster_whisper_model(model):
        parallel = False  # lockstep batching is a feature of the port's engine
    elif parallel is None:
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


# -- refine --------------------------------------------------------------------------------

def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To the card through pinned memory,
    queued without waiting: an upload from pageable memory would wait for
    the work already queued there, and a refine round's launch must not."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _whisper_refinement_func(model, tokenizer) -> Callable:
    """(audio[2, T], tokens) -> token probs (2, n_tokens, vocab < eot), one
    probe at a time: the two muted rows' mel on the model's device, the
    encoder, the teacher-forced decoder, the softmax downloaded (or the
    backend's own alignment API for adapter models)."""
    if is_faster_whisper_model(model):
        return fw_refinement_func(model, tokenizer)
    sot_len = len(tokenizer.sot_sequence)

    @torch.inference_mode()
    def inference_func(audio_segment: np.ndarray, tokens: List[int]) -> np.ndarray:
        input_tokens = [*tokenizer.sot_sequence, tokenizer.no_timestamps,
                        *tokens, tokenizer.eot]
        mel = _pad_mel(log_mel_spectrogram(np.asarray(audio_segment),
                                           model.dims.n_mels, device=model.device))
        xa = encoder_apply(model.params.encoder, mel)
        tok = torch.tensor([input_tokens], dtype=torch.long,
                           device=model.device).repeat(mel.shape[0], 1)
        logits, _ = decoder_apply(model.params.decoder, tok, xa)
        sampled = logits[:, sot_len:sot_len + len(tokens), :tokenizer.eot]
        return torch.softmax(sampled, dim=-1).cpu().numpy()

    return inference_func


def _refine_mel_batch(audio: torch.Tensor, frames: torch.Tensor,
                      n_mels: int) -> torch.Tensor:
    """(R, T_bucket) muted audio rows -> (R, n_mels, 3000) mels; frames at
    and past each row's real count ``frames`` (R,) are zeroed, as the
    sequential path's zero-padded mels are."""
    mel = log_mel_spectrogram(audio, n_mels)             # (R, n_mels, T // 160)
    mask = (torch.arange(mel.shape[-1], device=mel.device)[None, None, :]
            < frames[:, None, None])
    return _pad_mel(torch.where(mask, mel, 0.0))


def _muted_rows(clean: torch.Tensor, t_real: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Each span's two muted rows, (2S, T_bucket), as the host path
    assembles them: zeros on the intervals, the rest of the row's real
    samples, then the STFT's 200-sample reflect continuation of the MUTED
    row and zeros.

    clean (S, T_bucket) span audio, t_real (S,) real sample counts, lo/hi
    (2S, W) each row's disjoint zero intervals [lo, hi) (lo == hi: an
    empty slot). The mute mask is the running sum of +1/-1 boundaries,
    added with accumulation so that an empty slot's two cancel on one
    index, and summed in int32 (exact)."""
    s, t_pad = clean.shape
    dev = clean.device
    rows = clean.repeat_interleave(2, dim=0)                # (R, T)
    t_col = t_real.long().repeat_interleave(2)[:, None]      # (R, 1)
    bounds = torch.cat([lo, hi], dim=1).long().clamp(0, t_pad)
    ones = torch.ones(lo.shape, dtype=torch.int32, device=dev)
    diff = torch.zeros((2 * s, t_pad + 1), dtype=torch.int32, device=dev)
    diff.scatter_add_(1, bounds, torch.cat([ones, -ones], dim=1))
    muted = diff[:, :t_pad].cumsum(dim=1, dtype=torch.int32) > 0
    rows = torch.where(muted, 0.0, rows)
    # np.pad 'reflect' into the pad: padded[t + i] = row[t - 2 - i], a
    # (R, 200) gather scatter-added onto the rows cut at t; a clipped
    # destination adds a zero
    i = torch.arange(N_FFT // 2, device=dev)[None, :]
    refl = torch.clamp(t_col - 1, max=N_FFT // 2)
    padvals = rows.gather(1, torch.clamp(t_col - 2 - i, 0, t_pad - 1))
    live = (i < refl) & (t_col + i < t_pad)
    base = torch.where(torch.arange(t_pad, device=dev)[None, :] < t_col, rows, 0.0)
    return base.scatter_add(1, torch.clamp(t_col + i, 0, t_pad - 1),
                            torch.where(live, padvals, 0.0))


def _masked_mel_body(clean: torch.Tensor, t_real: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor,
                     n_mels: int) -> torch.Tensor:
    """Muted rows (:func:`_muted_rows`) -> (2S, n_mels, 3000) mels, frames
    past each row's real count zeroed (JAX's ``_masked_mel_body`` and its
    jitted wrapper ``_refine_masked_mel``). Rows of the span bucket past
    the real spans (t_real == 0) give all-zero mels."""
    frames = torch.clamp(t_real.long().repeat_interleave(2) // HOP_LENGTH,
                         max=N_FRAMES)
    return _refine_mel_batch(_muted_rows(clean, t_real, lo, hi), frames, n_mels)


def _probs_and_ranks(model, mel: torch.Tensor, tokens: torch.Tensor,
                     eot: int) -> torch.Tensor:
    """The encoder over ``mel``, the teacher-forced decoder over ``tokens``,
    then each realized token's probability and vocabulary rank, stacked as
    one (2, R, L - 1) f32 tensor for one download (ranks are exact in f32:
    ids < 2**24), left on the device."""
    xa = encoder_apply(model.params.encoder, mel)
    logits, _ = decoder_apply(model.params.decoder, tokens, xa)
    per_token, ranks = _next_token_probs_and_ranks(logits, tokens, eot)
    return torch.stack([per_token, ranks.float()])


def _refine_round_fused(model, clean, t_real, slots, lo, hi, tokens,
                        eot: int) -> torch.Tensor:
    """One bisection round over the spans in ``slots``: their muted rows'
    mels, then :func:`_probs_and_ranks`. JAX compiles these steps into one
    program; here they are queued in a row without waiting for the
    device."""
    mel = _masked_mel_body(clean[slots], t_real[slots], lo, hi,
                           model.dims.n_mels)
    return _probs_and_ranks(model, mel, tokens, eot)


def _whisper_refinement_batch_func(model, tokenizer) -> Callable:
    """list[(audio(2, T_i) or MutedSpanProbe, tokens_i)] -> list[(probs
    (2, n_i), ranks (2, n_i))]: the realized tokens' probabilities and
    vocabulary ranks.

    The Refiner's lockstep loop (``non_whisper/refinement.py``) evaluates
    every pending span's probe in ONE forward a bisection round: all 2S muted
    rows batch through the encoder and the decoder with right-padded token
    rows (exact under the causal mask). Spans bucket to powers of two,
    token rows to 32 and audio to 1 s. Span i is on rows 2i and 2i + 1;
    padding slots repeat the last span.

    In interval mode (``MutedSpanProbe``) each group's span audio goes up
    once a refine step (a new ``epoch``) and each round uploads only the
    mute intervals and runs only the spans still holding live words;
    ``launch`` queues a round and returns a handle without waiting, and
    ``collect`` downloads it. On a mesh each rank runs its rows of a round
    (``model.shard_batch``, where the JAX package calls it) and the round's
    stacked result is gathered over dp when it is launched; the clean
    span audio stays whole on every rank."""
    sot_seq = list(tokenizer.sot_sequence)
    sot_len = len(sot_seq)
    device = model.device

    def _bucket(n: int, step: int) -> int:
        return max(step, int(np.ceil(n / step) * step))

    def _pow2(n: int) -> int:
        return 1 << max(0, int(np.ceil(np.log2(n))))

    # one clean-audio cache a pipeline group (``key``), rebuilt at a new
    # step epoch; 'keep' pins the host arrays so that their ids stay unique
    states = {}

    def _launch_intervals(requests, key):
        probes = [p for p, _ in requests]
        toks = [sot_seq + [tokenizer.no_timestamps] + list(t)
                + [tokenizer.eot] for _, t in requests]
        lengths = [len(t) for _, t in requests]
        state = states.setdefault(key, {})
        epoch = getattr(probes[0], 'epoch', None)
        if state.get('epoch') != epoch:
            # a new epoch's first round carries every span of its group, so
            # the cache covers the later (shrinking) rounds; a span unknown
            # mid-epoch raises below (state['map'])
            t_max = max(p.clean.shape[-1] for p in probes)
            t_bucket = _bucket(t_max + N_FFT // 2, SAMPLE_RATE)
            s_b = _pow2(len(probes))
            clean_host = np.zeros((s_b, t_bucket), np.float32)
            t_real = np.zeros((s_b,), np.int32)
            for i, p in enumerate(probes):
                t = p.clean.shape[-1]
                clean_host[i, :t] = p.clean
                t_real[i] = t
            state.clear()
            state.update(
                epoch=epoch,
                map={id(p.clean): i for i, p in enumerate(probes)},
                keep=[p.clean for p in probes],
                clean=_upload(clean_host, device),
                t_real=_upload(t_real, device), w_b=8,
                max_len=_bucket(max(len(r) for r in toks), 32))
        max_len = max(state['max_len'],
                      _bucket(max(len(r) for r in toks), 32))
        state['max_len'] = max_len
        w_need = max((int(np.sum(p.rows == r)) for p in probes
                      for r in (0, 1)), default=1)
        while state['w_b'] < w_need:
            state['w_b'] *= 2
        w_b = state['w_b']

        # only the spans still holding live words, on rows 2i and 2i + 1 in
        # request order, so late rounds stop paying the whole step batch's
        # encoder
        slot_list = [state['map'][id(p.clean)] for p in probes]
        a_b = _pow2(len(probes))
        if model.mesh is not None:
            # the muted rows of span i are rows 2i and 2i + 1: the span
            # bucket itself is a dp multiple, so that a rank's spans and
            # their rows split alike (JAX: alignment.py:715-721)
            dp = model.mesh['dp'].size()
            a_b = max(a_b, dp) if dp & (dp - 1) == 0 else int(np.lcm(a_b, dp))
        lo = np.zeros((2 * a_b, w_b), np.int32)
        hi = np.zeros((2 * a_b, w_b), np.int32)
        tok_batch = np.full((2 * a_b, max_len), tokenizer.eot, np.int64)
        for i, (p, row_tok) in enumerate(zip(probes, toks)):
            tok_batch[2 * i:2 * i + 2, :len(row_tok)] = row_tok
            for r in (0, 1):
                sel = p.rows == r
                cnt = int(sel.sum())
                lo[2 * i + r, :cnt] = p.zero_lo[sel]
                hi[2 * i + r, :cnt] = p.zero_hi[sel]
        slots = np.asarray(slot_list + [slot_list[-1]] * (a_b - len(probes)),
                           np.int64)
        stacked = _refine_round_fused(
            model, state['clean'], state['t_real'], model.shard_batch(slots)[0],
            model.shard_batch(lo)[0], model.shard_batch(hi)[0],
            model.shard_batch(tok_batch)[0], tokenizer.eot)
        return (model.gather_batch(stacked, dim=1),
                [2 * i for i in range(len(probes))], lengths)

    def collect(handle):
        """Download a launched round's results (one download) -> reply
        list."""
        stacked, row0s, lengths = handle
        arr = stacked.cpu().numpy()
        per_token, ranks = arr[0], arr[1].astype(np.int64)
        out = []
        for r0, n in zip(row0s, lengths):
            sl = (slice(r0, r0 + 2), slice(sot_len, sot_len + n))
            out.append((per_token[sl], ranks[sl]))
        return out

    @torch.inference_mode()
    def launch(requests, key=0):
        """Queue one bisection round without waiting for its results:
        returns a handle for :func:`collect`. The lockstep loop overlaps
        two span groups through this split: group A's round computes on
        the device while group B's host update runs."""
        if requests and isinstance(requests[0][0], MutedSpanProbe):
            return _launch_intervals(requests, key)
        return _launch_audio(requests)

    def _launch_audio(requests):
        audios = []
        rows = []
        lengths = []
        for audio_segment, tokens in requests:
            a = np.asarray(audio_segment, np.float32)
            audios.append(a[None] if a.ndim == 1 else a)
            rows.append(sot_seq + [tokenizer.no_timestamps] + list(tokens)
                        + [tokenizer.eot])
            lengths.append(len(tokens))
        # one audio bucket a round, with room for the longest span plus the
        # 200-sample reflect tail, at 1-s granularity
        t_max = max(a.shape[-1] for a in audios)
        t_bucket = _bucket(t_max + N_FFT // 2, SAMPLE_RATE)
        n_rows = sum(a.shape[0] for a in audios)
        pad_rows = max(2, _pow2(n_rows))
        audio_batch = np.zeros((pad_rows, t_bucket), np.float32)
        frames = np.zeros((pad_rows,), np.int64)
        r = 0
        for a in audios:
            t = a.shape[-1]
            refl = min(N_FFT // 2, t - 1) if t > 1 else 0
            for row in a:
                audio_batch[r, :t] = row
                if refl:
                    # np.pad 'reflect' continuation: padded[t+i] = row[t-2-i]
                    # (stop pinned to None when the reflection reaches
                    # row[0]: a negative stop would wrap and empty the slice
                    # for spans of <= N_FFT//2 + 1 samples)
                    stop = t - 2 - refl
                    audio_batch[r, t:t + refl] = \
                        row[t - 2:stop if stop >= 0 else None:-1]
                frames[r] = min(t // HOP_LENGTH, N_FRAMES)
                r += 1
        max_len = _bucket(max(len(row) for row in rows), 32)
        tok_batch = np.full((pad_rows, max_len), tokenizer.eot, np.int64)
        row_starts = []
        r = 0
        for a, row in zip(audios, rows):
            row_starts.append(r)
            tok_batch[r:r + a.shape[0], :len(row)] = row
            r += a.shape[0]
        tokens_in = model.shard_batch(tok_batch)[0]
        mel_batch = _refine_mel_batch(model.shard_batch(audio_batch)[0],
                                      model.shard_batch(frames)[0], model.dims.n_mels)
        return (model.gather_batch(_probs_and_ranks(
                    model, mel_batch, tokens_in, tokenizer.eot), dim=1),
                row_starts, lengths)

    def batch_func(requests):
        return collect(launch(requests))

    batch_func.accepts_intervals = (
        os.environ.get('STABLE_TS_TPU_REFINE_INTERVALS', '1') != '0')
    batch_func.launch = launch
    batch_func.collect = collect
    return batch_func


@traced('refine')
def refine(
        model,
        audio,
        result: WhisperResult,
        *,
        steps: Optional[str] = None,
        rel_prob_decrease: float = .03,
        abs_prob_decrease: float = .05,
        rel_rel_prob_decrease: Optional[float] = None,
        prob_threshold: float = .5,
        rel_dur_change: Optional[float] = .5,
        abs_dur_change: Optional[float] = None,
        word_level: bool = True,
        precision: Optional[float] = None,
        single_batch: bool = False,
        inplace: bool = True,
        parallel: Optional[bool] = None,
        **options,
) -> WhisperResult:
    """Sharpen ``result``'s timestamps by iterative mute-and-bisect probing.

    ``parallel`` (default: on when the model's weights lie on a CUDA
    device) runs every span's bisection in lockstep with one batched
    forward a round instead of a loop over the spans;
    ``single_batch=True`` forces the loop (the reference CLI's switch).
    """
    if result and (not result.has_words
                   or any(w.probability is None for w in result.all_words())):
        if not result.language:
            raise RuntimeError('cannot align words with result missing language')
        align_words(model, audio, result)
    if is_faster_whisper_model(model):
        tokenizer = fw_tokenizer(model, result.language)
    else:
        tokenizer = model.get_tokenizer(language=result.language,
                                        task='transcribe')
    if result and not all(w.tokens for w in result.all_words()):
        for word in result.all_words():
            word.tokens = tokenizer.encode(word.word)

    if single_batch or is_faster_whisper_model(model):
        parallel = False
    elif parallel is None:
        parallel = model.device.type == 'cuda'
    all_options = AllOptions(options, post=False, silence=False, align=False)
    refiner = Refiner(
        inference_func=_whisper_refinement_func(model, tokenizer),
        batch_inference_func=(_whisper_refinement_batch_func(model, tokenizer)
                              if parallel else None),
        sample_rate=SAMPLE_RATE,
        steps=steps,
        rel_prob_decrease=rel_prob_decrease,
        abs_prob_decrease=abs_prob_decrease,
        rel_rel_prob_decrease=rel_rel_prob_decrease,
        prob_threshold=prob_threshold,
        rel_dur_change=rel_dur_change,
        abs_dur_change=abs_dur_change,
        word_level=word_level,
        precision=precision,
        max_inference_tokens=(model.dims.n_text_ctx - 6
                              if hasattr(model, 'dims') else 442),
        all_options=all_options,
    )
    return refiner.refine(audio, result, inplace)


# -- locate --------------------------------------------------------------------------------

def _estimate_matrix(weights: torch.Tensor) -> torch.Tensor:
    """(heads, T, F) captured QK rows -> the (T, F) attention matrix of the
    end estimate: the softmax over frames in f32 (the capture is bf16),
    z-scores over the tokens (standard deviation with ``correction=0``, as
    ``jnp.std``; a zero deviation divides by 1), the median filter of
    width 7, the mean over heads."""
    weights = torch.softmax(weights.float(), dim=-1)
    std = weights.std(dim=-2, keepdim=True, correction=0)
    mean = weights.mean(dim=-2, keepdim=True)
    weights = median_filter((weights - mean) / torch.where(std == 0, 1.0, std), 7)
    return weights.mean(dim=0)


def _estimate_program(model, capture_index, layers, cols, audio: torch.Tensor,
                      tokens: torch.Tensor):
    """One 30-s search chunk, (1, N_SAMPLES) on the device: mel, encoder,
    teacher-forced capture (with ``capture_index``, only the alignment
    heads' rows, which ``layers`` and ``cols`` pick; else every head), then
    the frame where the last text token attends most, as a device scalar,
    and the chunk's mel, which stays on the device for the confirmation
    decode. The index tensors lie on the device already, so nothing waits
    for it."""
    mel = log_mel_spectrogram(audio, model.dims.n_mels)[..., :N_FRAMES]
    xa = encoder_apply(model.params.encoder, mel)
    _, qks = decoder_apply(model.params.decoder, tokens, xa, capture_qk=True,
                           capture_index=capture_index)
    if layers is not None:
        weights = qks[layers, 0, cols]                      # (n_sel, T, F)
    else:
        n_layers, _, n_head, t, f = qks.shape
        weights = qks[:, 0].reshape(n_layers * n_head, t, f)
    return torch.argmax(_estimate_matrix(weights)[-1]), mel


@traced('locate')
def locate(
        model,
        audio,
        text: Union[str, List[int]],
        language: str,
        count: int = 1,
        duration_window: Union[float, Tuple[float, float]] = 3.0,
        *,
        mode: int = 0,
        start: Optional[float] = None,
        end: Optional[float] = None,
        probability_threshold: float = 0.5,
        eots: int = 1,
        max_token_per_seg: int = 20,
        exact_token: bool = False,
        case_sensitive: bool = False,
        verbose: Optional[bool] = False,
        initial_prompt: Optional[str] = None,
        suppress_tokens: Union[str, List[int]] = '-1',
        denoiser: Optional[str] = None,
        denoiser_options: Optional[dict] = None,
        only_voice_freq: bool = False,
        demucs=None,
        demucs_options: Optional[dict] = None,
) -> Union[List[Segment], List[dict]]:
    """Find when ``text`` is spoken without transcribing everything.

    mode 2: end-time estimate only (argmax of the last text token's
    cross-attention row). mode 1: + confirmation decode around the estimate.
    mode 0: + word timestamps on the confirmed match.
    """
    if is_faster_whisper_model(model):
        # as in stable_ts_tpu, whose locate has no faster-whisper branch
        # and whose modify_fw_model attaches no locate
        raise NotImplementedError('locate runs on a WhisperTorch model only; '
                                  'faster-whisper models have no locate')
    from .audio import prep_audio
    from .audio.denoiser import convert_demucs_kwargs
    from .models.whisper.decoding import (DecodingOptions, build_initial_tokens,
                                          build_suppress_list)
    from .models.whisper.model import (decoder_prefill, fuse_self_qkv,
                                       precompute_cross_kv_t)
    denoiser, denoiser_options = convert_demucs_kwargs(
        denoiser, denoiser_options, demucs=demucs,
        demucs_options=demucs_options)

    tokenizer = model.get_tokenizer(language=language, task='transcribe')
    device = model.device
    sec_per_emb = model.dims.n_audio_ctx / CHUNK_LENGTH
    chunk_samples = round(CHUNK_LENGTH * SAMPLE_RATE)
    if isinstance(duration_window, (float, int)):
        duration_window = [duration_window] * 2
    window_sum = sum(duration_window)
    assert chunk_samples > window_sum, \
        f'Sum of [duration_window] must be less than {chunk_samples}, got {window_sum}'
    adjusted_chunk_size = chunk_samples - round(duration_window[0] * SAMPLE_RATE)
    if initial_prompt:
        initial_prompt = ' ' + initial_prompt.strip()
    d_options = DecodingOptions(language=language, prompt=initial_prompt,
                                suppress_tokens=suppress_tokens,
                                without_timestamps=True)
    initial_tokens, _, _ = build_initial_tokens(tokenizer, d_options,
                                                model.dims.n_text_ctx)
    if isinstance(text, str):
        text_tokens, text_str = tokenizer.encode(text), text
    else:
        text_tokens, text_str = list(text), tokenizer.decode(text)
    if not exact_token and not case_sensitive:
        text_str = text_str.lower()
    suppress_ids = [i for i in build_suppress_list(tokenizer, d_options)
                    if i < tokenizer.eot]

    audio = prep_audio(audio, denoiser=denoiser,
                       denoiser_options=denoiser_options,
                       only_voice_freq=only_voice_freq)
    if end:
        audio = audio[:round(end * SAMPLE_RATE)]
    seek_sample = round(start * SAMPLE_RATE) if start else 0
    total_samples = audio.shape[-1]
    prev_target_end = None
    found = 0

    # with known alignment heads, capture only their QK rows (the batched
    # timing pass's table); else every head. Uploaded once, here.
    loc_capture_index = est_layers = est_cols = None
    if model.alignment_heads is not None:
        table, slots = build_head_capture_table(model.alignment_heads,
                                                model.dims.n_text_layer)
        loc_capture_index = torch.as_tensor(table, device=device)
        est_layers = torch.tensor([l for l, _ in slots], device=device)
        est_cols = torch.tensor([c for _, c in slots], device=device)
    est_tokens = torch.tensor([initial_tokens + text_tokens], dtype=torch.long,
                              device=device)

    def launch_estimate(seek_s: int):
        """Queue the end estimate of the chunk at ``seek_s`` without waiting:
        (frame index, mel) on the device. Launches are asynchronous, so the
        next chunk's estimate can be queued behind this chunk's
        confirmation work."""
        segment = audio[seek_s:seek_s + chunk_samples]
        padded = np.zeros((1, N_SAMPLES), np.float32)
        padded[0, :segment.shape[-1]] = segment[:N_SAMPLES]
        return _estimate_program(model, loc_capture_index, est_layers, est_cols,
                                 _upload(padded, device), est_tokens)

    # the next chunk's seek is known whenever this chunk does NOT match (a
    # fixed stride), the common case of a scan: its estimate is queued
    # before this chunk's confirmation runs; a match advances the seek
    # otherwise and drops the entry
    _spec_est = {}

    decoder = model.params.decoder
    fused_qkv = fuse_self_qkv(decoder)
    # worst-case token count: initial prompt + the bounded prediction run
    confirm_cache_len = min(
        model.dims.n_text_ctx,
        ((len(initial_tokens) + max_token_per_seg + 8 + 127) // 128) * 128)

    def _row(logits: torch.Tensor) -> np.ndarray:
        return logits[:tokenizer.eot + 1].cpu().numpy().copy()

    def greedy_confirm(mel_section: torch.Tensor):
        """KV-cached greedy decode with target-token forcing and rollback.

        The reference re-runs the whole prefix through the model a token
        (its alignment.py:845-867); here appending one token is ONE
        ``decoder_step`` against the held float cache, and only a rollback
        (suffix replaced) re-prefills, right-padded to a 32-bucket."""
        xa = encoder_apply(model.params.encoder, mel_section[None])
        # float cross K/V, as the JAX package keeps them here
        cross_kv = precompute_cross_kv_t(decoder, xa)
        state = dict(kv=None, tokens=[])

        def logits_at(tokens_so_far: List[int]):
            n = len(tokens_so_far)
            if (state['kv'] is not None and n == len(state['tokens']) + 1
                    and n <= confirm_cache_len
                    and tokens_so_far[:-1] == state['tokens']):
                tok = torch.tensor([[tokens_so_far[-1]]], dtype=torch.long,
                                   device=device)
                logits = decoder_step(decoder, tok, n - 1, cross_kv,
                                      state['kv'], fused_qkv)
                state['tokens'] = list(tokens_so_far)
                return _row(logits[0])
            # (re)prefill, right-padded to a 32-bucket (positions past the
            # real prefix hold junk K/V, but decoder_step attends no key
            # past its position and overwrites its slot first)
            pad = min(confirm_cache_len, -(-n // 32) * 32)
            toks = torch.tensor([tokens_so_far + [tokenizer.eot] * (pad - n)],
                                dtype=torch.long, device=device)
            logits, state['kv'] = decoder_prefill(decoder, toks, xa,
                                                  confirm_cache_len,
                                                  int8_cache=False)
            state['tokens'] = list(tokens_so_far)
            return _row(logits[0, n - 1])

        infer_tokens = list(initial_tokens)
        predictions = []
        target_token_idx = 0
        not_end = True
        found_target = False
        curr_eots = 0
        tokens_to_decode: List[int] = []
        replace_found_tokens: List[int] = []
        while not_end:
            logits = logits_at(infer_tokens)
            logits[suppress_ids] = -np.inf
            order = np.argsort(logits)
            best_token = int(order[-1])
            best_non_eot = int(order[-2]) if best_token == tokenizer.eot else best_token
            probs = logits[:tokenizer.eot]
            probs = np.exp(probs - probs.max())
            probs /= probs.sum()
            if found_target:
                target_word_prob = is_match = None
            else:
                if exact_token:
                    is_match = False
                else:
                    tokens_to_decode.append(best_non_eot)
                    temp_text = tokenizer.decode(tokens_to_decode)
                    if not case_sensitive:
                        temp_text = temp_text.lower()
                    if is_match := temp_text.endswith(text_str):
                        tokens_to_decode = []
                target_word_prob = float(probs[text_tokens[target_token_idx]])
            if (target_word_prob is not None
                    and (target_word_prob >= probability_threshold
                         or best_non_eot == text_tokens[target_token_idx]
                         or is_match)):
                if is_match:
                    best_token = best_non_eot
                    token_prob = float(probs[best_token])
                    found_target = True
                else:
                    if replace_found_tokens or best_non_eot != text_tokens[target_token_idx]:
                        replace_found_tokens.append(best_non_eot)
                    best_token = text_tokens[target_token_idx]
                    target_token_idx += 1
                    if target_token_idx == len(text_tokens):
                        found_target = True
                    token_prob = target_word_prob
                curr_eots = 0
            else:
                if not found_target:
                    if replace_found_tokens:
                        n = len(replace_found_tokens)
                        infer_tokens = infer_tokens[:-n] + replace_found_tokens
                        replace_found_tokens = []
                    target_token_idx = 0
                if best_token == tokenizer.eot:
                    if curr_eots >= eots or found_target:
                        not_end = False
                    else:
                        curr_eots += 1
                        best_token = best_non_eot
                else:
                    curr_eots = 0
                token_prob = (None if best_token == tokenizer.eot
                              else float(probs[best_token]))
            predictions.append(dict(token=best_token, prob=token_prob))
            if len(predictions) > max_token_per_seg:
                not_end = False
            if not_end:
                infer_tokens.append(best_token)
        return found_target, predictions

    def _locate():
        nonlocal seek_sample, found, prev_target_end
        seek = round(seek_sample / SAMPLE_RATE, 3)
        audio_segment = audio[seek_sample:seek_sample + chunk_samples]

        if seek_sample in _spec_est:
            frame, mel_dev = _spec_est.pop(seek_sample)
        else:
            frame, mel_dev = launch_estimate(seek_sample)
        _spec_est.clear()
        if mode != 2 and not (count and found + 1 >= count):
            # queue the next no-match chunk's estimate behind this one,
            # unless a confirmation here would already reach ``count`` and
            # end the search (a wasted device pass a confirmed match)
            nxt = seek_sample + (adjusted_chunk_size
                                 if audio_segment.shape[-1] == chunk_samples
                                 else audio_segment.shape[-1])
            if nxt < total_samples:
                _spec_est[nxt] = launch_estimate(nxt)
        target_end = round(float(frame) / sec_per_emb, 3)
        mel_segment = mel_dev[0]
        found_msg = (f'"{text_str}" ending at ~{format_timestamp(target_end + seek)}'
                     if verbose else '')

        if mode == 2:
            if found_msg:
                safe_print('Unconfirmed: ' + found_msg)
            found += 1
            if ((seek_sample + chunk_samples >= total_samples)
                    or (count and found >= count)
                    or (prev_target_end == target_end)):
                seek_sample = total_samples
            else:
                seek_sample += round(target_end * SAMPLE_RATE)
            prev_target_end = target_end
            return dict(tokens=[], target_end=target_end + seek)

        curr_start = round(max(target_end - duration_window[0], 0.), 3)
        curr_end = round(target_end + duration_window[1], 3)
        start_frame = round(curr_start * FRAMES_PER_SECOND)
        end_frame = round(curr_end * FRAMES_PER_SECOND)
        mel_section = _pad_mel(mel_segment[..., start_frame:end_frame])

        found_target, predictions = greedy_confirm(mel_section)
        segment = None
        if found_target:
            if found_msg:
                safe_print('Confirmed: ' + found_msg)
            final_tokens = [p['token'] for p in predictions]
            if mode == 1:
                _, (ws, wts), _ = split_word_tokens(
                    [dict(tokens=final_tokens)], tokenizer)
                final_token_probs = [p['prob'] for p in predictions]
                wps = [float(np.mean([final_token_probs.pop(0) or 0.0
                                      for _ in wt])) for wt in wts]
                words = [dict(word=w, tokens=wt, probability=wp)
                         for w, wt, wp in zip(ws, wts, wps)]
                segment = dict(end=target_end + seek, text=text_str,
                               duration_window_text=''.join(ws),
                               duration_window_word=words)
                if verbose:
                    safe_print(f'Duration Window: "{"".join(ws)}"\n')
                seek_sample += round(curr_end * SAMPLE_RATE)
            else:
                segment = dict(seek=0, tokens=final_tokens)
                add_word_timestamps(
                    segments=[segment],
                    model=model.params,
                    dims=model.dims,
                    tokenizer=tokenizer,
                    mel=mel_segment,
                    num_samples=round(curr_end * SAMPLE_RATE),
                    gap_padding=None,
                    alignment_heads=model.alignment_heads,
                )
                segment = Segment(words=segment['words'])
                seek_sample += round(segment.words[-1].end * SAMPLE_RATE)
                segment.offset_time(seek)
                segment.seek = curr_start
                if verbose:
                    safe_print(segment.to_display_str())
            found += 1
        else:
            seek_sample += (adjusted_chunk_size
                            if audio_segment.shape[-1] == chunk_samples
                            else audio_segment.shape[-1])
        return segment

    matches = []
    with torch.inference_mode():
        while seek_sample < total_samples and (not count or found < count):
            match = _locate()
            if match:
                matches.append(match)
    if verbose and not matches:
        safe_print(f'Failed to locate "{text_str}".')
    return matches
