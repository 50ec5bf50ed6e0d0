"""Word-level timestamps from cross-attention + DTW (port of
stable_ts_tpu/models/whisper/timing.py, the legacy aligner with known
alignment heads).

One teacher-forced decoder pass captures the alignment heads' raw QK
(:func:`compute_qks_and_probs`); on the model's device the selected heads
are soft-maxed over the window's real frames, normalized per frame column,
reflect-continued at the crop boundary and median filtered
(:func:`legacy_head_weights`); the DTW cost comes from the kernel
(``ops/dtw.py``), and the host walks the traceback for the per-token jump
frames. The word splitting and assembly helpers below are host code,
carried over because their JAX module imports jax.

Dynamic head selection and the 'new' aligner are not ported yet
(ROADMAP.md) and raise ``NotImplementedError``.
"""
import string
from dataclasses import dataclass
from itertools import chain
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stable_ts_tpu.constants import N_SAMPLES_PER_TOKEN, TOKENS_PER_SECOND

from ...ops.dtw import dtw_cost, dtw_jumps
from ...ops.median import median_filter
from .model import decoder_apply, encoder_apply


@dataclass
class WordTimingRaw:
    word: Optional[str]
    tokens: List[int]
    start: float
    end: float
    probability: float


def build_head_capture_table(alignment_heads, n_layers: int):
    """Pack (layer, head) pairs into a per-layer slot table.

    Returns (capture_index (L, max_slots) int64, slot_of_pair aligned with
    ``alignment_heads``: the (layer, slot) holding that pair's QK rows).
    Unused slots repeat head 0 and are never read back."""
    per_layer: List[List[int]] = [[] for _ in range(n_layers)]
    slots = []
    for layer, head in alignment_heads:
        slots.append((int(layer), len(per_layer[int(layer)])))
        per_layer[int(layer)].append(int(head))
    width = max(1, max(len(heads) for heads in per_layer))
    table = np.zeros((n_layers, width), np.int64)
    for layer, heads in enumerate(per_layer):
        table[layer, :len(heads)] = heads
    return table, slots


def gather_captured_heads(qks: torch.Tensor, slots) -> torch.Tensor:
    """(L, max_slots, T, F) selective capture -> (n_sel, T, F) rows."""
    layers = torch.tensor([layer for layer, _ in slots], device=qks.device)
    cols = torch.tensor([slot for _, slot in slots], device=qks.device)
    return qks[layers, cols]


@torch.inference_mode()
def compute_qks_and_probs(model, dims, tokenizer, text_tokens: Sequence[int],
                          mel: Optional[torch.Tensor] = None,
                          audio_features: Optional[torch.Tensor] = None,
                          capture_index=None):
    """One teacher-forced pass -> (qks (L, slots, T, F) bf16, per-token
    probabilities of the text tokens, audio_features)."""
    if audio_features is None:
        if mel is None:
            raise ValueError('need mel or audio_features')
        if mel.ndim == 2:
            mel = mel[None]
        audio_features = encoder_apply(model.encoder, mel)
    tokens = [*tokenizer.sot_sequence, tokenizer.no_timestamps,
              *text_tokens, tokenizer.eot]
    tokens_t = torch.tensor([tokens], dtype=torch.long,
                            device=audio_features.device)
    logits, qks = decoder_apply(model.decoder, tokens_t, audio_features,
                                capture_qk=True, capture_index=capture_index)
    sot_len = len(tokenizer.sot_sequence)
    probs = torch.softmax(logits[0, sot_len:, :tokenizer.eot], dim=-1)
    idx = torch.arange(len(text_tokens), device=probs.device)
    text_ids = torch.tensor(list(text_tokens), dtype=torch.long,
                            device=probs.device)
    text_token_probs = probs[idx, text_ids].cpu().numpy()
    return qks[:, 0], text_token_probs.tolist(), audio_features


def reflect_src(length: int, n_frames: int, device=None) -> torch.Tensor:
    """Column sources that write np.pad-'reflect' continuations past a
    crop boundary: column >= length reads column 2*length - 2 - column
    (timing.py:108-121)."""
    idx = torch.arange(n_frames, device=device)
    return torch.where(idx < length, idx,
                       torch.clamp(2 * length - 2 - idx, 0, n_frames - 1))


def legacy_head_weights(qks_sel: torch.Tensor, max_qk_len: int, sot_len: int,
                        qk_scale: float, medfilt_width: int) -> torch.Tensor:
    """Normalized, median-filtered attention weights of the selected heads
    (timing.py:124-143). qks_sel (n_sel, T, F) -> (n_sel, T - sot_len - 1, F)
    f32; columns >= max_qk_len hold the reflect continuation of the crop
    (bound the DTW at max_qk_len)."""
    w = qks_sel[:, sot_len:-1, :].float()
    frames = w.shape[-1]
    mask = torch.arange(frames, device=w.device) < max_qk_len
    w = torch.where(mask, w * qk_scale, -torch.inf)
    w = torch.softmax(w, dim=-1)
    w = torch.where(mask, w, 0.0)
    std, mean = torch.std_mean(w, dim=-2, keepdim=True, correction=0)
    # constant columns (e.g. one token) have std 0: NaNs would poison DTW
    w = (w - mean) / torch.where(std > 0, std, 1.0)
    w = w[..., reflect_src(max_qk_len, frames, w.device)]
    return median_filter(w, medfilt_width)


def matrix_to_jumps(matrix: torch.Tensor, m: Optional[int] = None) -> np.ndarray:
    """DTW over -matrix (device cost, host traceback) -> per-token jump
    frames; ``m`` bounds the walk to the first m frame columns."""
    n, m_full = matrix.shape
    m = m_full if m is None else min(m, m_full)
    cost = dtw_cost(-matrix.float()).cpu().numpy()
    return dtw_jumps(cost, n, m)


def find_alignment(model, dims, tokenizer, text_tokens: List[int],
                   mel: Optional[torch.Tensor], num_samples: int, *,
                   medfilt_width: int = 7, qk_scale: float = 1.0,
                   token_split=None,
                   audio_features: Optional[torch.Tensor] = None,
                   alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
                   dynamic_heads=None, aligner='legacy',
                   extra_models=None) -> List[WordTimingRaw]:
    """Align ``text_tokens`` to audio with the legacy aligner and known
    alignment heads (timing.py:522-700); per-word raw timings."""
    if aligner != 'legacy' or dynamic_heads or alignment_heads is None:
        raise NotImplementedError(
            'stable_ts_tpu_torch aligns with the legacy aligner and known '
            'alignment heads only; dynamic heads and the "new" aligner are '
            'still to be ported (ROADMAP.md)')
    if extra_models:
        raise NotImplementedError('extra_models are still to be ported '
                                  '(ROADMAP.md)')
    if token_split is None:
        words, word_tokens = tokenizer.split_to_word_tokens(
            list(text_tokens) + [tokenizer.eot])
    else:
        words, word_tokens = token_split
        words = list(words) + [tokenizer.decode([tokenizer.eot])]
        word_tokens = list(word_tokens) + [[tokenizer.eot]]
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    sot_len = len(tokenizer.sot_sequence)
    max_qk_len = round(num_samples / N_SAMPLES_PER_TOKEN)
    capture_index, slots = build_head_capture_table(alignment_heads,
                                                    dims.n_text_layer)
    with torch.inference_mode():
        qks, text_token_probs, _ = compute_qks_and_probs(
            model, dims, tokenizer, text_tokens, mel=mel,
            audio_features=audio_features, capture_index=capture_index)
        weights = legacy_head_weights(gather_captured_heads(qks, slots),
                                      max_qk_len, sot_len, qk_scale,
                                      medfilt_width)
        jump_indices = matrix_to_jumps(weights.mean(dim=0), m=max_qk_len)

    jump_times = jump_indices / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        float(np.mean(text_token_probs[i:j]))
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]
    return [
        WordTimingRaw(word, tokens, float(start), float(end), probability)
        for word, tokens, start, end, probability in zip(
            words, word_tokens, start_times, end_times, word_probabilities)
    ]


# -- word splitting across segments (gap padding); host code ------------------------------

def _split_tokens(tokens: List[int], tokenizer):
    """Split a token list into display words (timing.py:774-808)."""
    split_by_space = (tokenizer.language or 'en') not in {'zh', 'ja', 'th',
                                                          'lo', 'my', 'yue'}
    text = tokenizer.decode_with_timestamps(tokens)
    words: List[str] = []
    word_tokens: List[List[int]] = []
    curr_tokens: List[int] = []
    curr_text = ''
    is_append = False
    for token in tokens:
        curr_tokens.append(token)
        curr_text = tokenizer.decode(curr_tokens)
        is_whole = token >= tokenizer.eot
        if not is_whole:
            is_whole = text[:len(curr_text)] == curr_text
            if is_whole and split_by_space:
                is_append = not (curr_text.startswith(' ')
                                 or curr_text.strip() in string.punctuation)
        if is_whole:
            if is_append and len(words) != 0:
                words[-1] += curr_text
                word_tokens[-1].extend(curr_tokens)
            else:
                words.append(curr_text)
                word_tokens.append(curr_tokens)
            text = text[len(curr_text):]
            curr_tokens = []
    if len(curr_tokens) != 0:
        words.append(curr_text if len(text) == 0 else text)
        word_tokens.append(curr_tokens)
    elif len(text) != 0:
        words[-1] += text
    return words, word_tokens


def split_word_tokens(segments: List[dict], tokenizer, *, padding=None,
                      split_callback: Optional[Callable] = None,
                      pad_first_seg: bool = True):
    """Flatten segments into (tokens, (words, word_tokens), seg_indices),
    inserting ``padding`` tokens between segments (timing.py:811-843)."""
    if padding is not None:
        padding = tokenizer.encode(padding) if isinstance(padding, str) else [padding]
    tokens: List[int] = []
    seg_indices: List[int] = []
    words: List[Optional[str]] = []
    word_tokens: List[List[int]] = []
    for i, s in enumerate(segments):
        seg_tokens = [t for t in s['tokens']
                      if not isinstance(t, int) or t < tokenizer.eot]
        if split_callback is None:
            curr_words, curr_word_tokens = _split_tokens(seg_tokens, tokenizer)
        else:
            curr_words, curr_word_tokens = split_callback(seg_tokens, tokenizer)
        if len(curr_words) != len(curr_word_tokens):
            raise ValueError('word count and token group count do not match')
        if (padding is not None and curr_word_tokens
                and curr_word_tokens[0][0] != padding
                and (len(tokens) == 0 or tokens[-1] != padding)
                and (pad_first_seg or i != 0)):
            tokens.extend(padding)
            words.append(None)
            word_tokens.append(padding)
        seg_indices.extend([i] * len(curr_words))
        tokens.extend(chain.from_iterable(curr_word_tokens))
        words.extend(curr_words)
        word_tokens.extend(curr_word_tokens)
    return tokens, (words, word_tokens), seg_indices


def pop_empty_alignment(alignment: List[WordTimingRaw],
                        seg_indices: Optional[List[int]] = None):
    """Remove gap-padding entries; map them to the segment they precede."""
    if seg_indices is not None:
        seg_idx_pos = len(seg_indices)
        empties = {}
        for i in reversed(range(len(alignment))):
            if alignment[i].word is None:
                empties[seg_indices[min(seg_idx_pos, len(seg_indices) - 1)]] = \
                    alignment.pop(i)
            else:
                seg_idx_pos -= 1
        return empties
    return list(reversed([alignment.pop(i)
                          for i in reversed(range(len(alignment)))
                          if alignment[i].word is None]))


def merge_punctuations(alignment: List[WordTimingRaw],
                       prepended: str = "\"'“¿([{-",
                       appended: str = "\"'.。,，!！?？:：”)]}、"):
    """Merge leading / trailing punctuation into neighboring words."""
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous.word.startswith(' ') and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ''
            previous.tokens = []
        else:
            j = i
        i -= 1
    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous.word.endswith(' ') and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ''
            following.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(*, segments: List[dict], model, dims, tokenizer,
                        mel: Optional[torch.Tensor], num_samples: int,
                        prepend_punctuations: str = "\"'“¿([{-",
                        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
                        audio_features: Optional[torch.Tensor] = None,
                        min_word_dur: float = 0.1,
                        split_callback: Optional[Callable] = None,
                        gap_padding: Optional[str] = ' ...',
                        pad_first_seg: bool = True, **kwargs):
    """Attach word dicts to each segment in place (timing.py:899-965)."""
    if len(segments) == 0:
        return
    if min_word_dur is None:
        min_word_dur = 0
    if prepend_punctuations is None:
        prepend_punctuations = "\"'“¿([{-"
    if append_punctuations is None:
        append_punctuations = "\"'.。,，!！?？:：”)]}、"

    for seg in segments:
        seg['words'] = []

    text_tokens, token_split, seg_indices = split_word_tokens(
        segments, tokenizer, padding=gap_padding,
        split_callback=split_callback, pad_first_seg=pad_first_seg)
    if not text_tokens:
        return

    alignment = find_alignment(
        model, dims, tokenizer, text_tokens, mel, num_samples,
        token_split=token_split, audio_features=audio_features, **kwargs)
    alt_beginning_alignment = pop_empty_alignment(alignment, seg_indices)

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]['seek']
    if len(alignment) != len(seg_indices):
        raise RuntimeError('alignment and segment indices disagree')
    for i, timing in zip(seg_indices, alignment):
        if len(timing.tokens) != 0:
            start = timing.start
            end = timing.end
            if (len(segments[i]['words']) == 0
                    and (end - start) < min_word_dur
                    and i in alt_beginning_alignment):
                start = alt_beginning_alignment[i].start
            segments[i]['words'].append(dict(
                word=timing.word,
                start=round(time_offset + start, 3),
                end=round(time_offset + end, 3),
                probability=timing.probability,
                tokens=timing.tokens,
            ))

    for segment in segments:
        words = segment['words']
        if len(words) > 0:
            segment['start'] = words[0]['start']
            segment['end'] = words[-1]['end']
