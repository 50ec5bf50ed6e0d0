"""Word-level timestamps from cross-attention + DTW (port of
stable_ts_tpu/models/whisper/timing.py: the legacy aligner with known or
dynamically selected alignment heads, the 'new' aligner, and extra
models).

One teacher-forced decoder pass captures raw cross-attention QK
(:func:`compute_qks_and_probs`). With known heads it captures only those,
and on the model's device they are soft-maxed over the window's real
frames, normalized per frame column, reflect-continued at the crop
boundary and median filtered (:func:`legacy_head_weights`). With no known
heads, or when ``dynamic_heads`` asks for it, it captures every head; the
frame axis is cropped on the device, downloaded in bf16 and widened on the
host, where :func:`_dynamic_head_weights` picks each token's best-peaked
heads (the reference's selection, NumPy as in the JAX package). The 'new'
aligner (arXiv 2509.09987) also captures every head and scores them on
the device, a chunk of heads at a time (:func:`new_aligner_matrix`); the
capture never goes to the host. ``extra_models`` each take their own
capture pass on the same mel and select their own heads; their weights
join the main model's before the head mean and their token probabilities
average in. Either way the DTW cost comes from the kernel
(``ops/dtw.py``), and the host walks the traceback for the per-token jump
frames. The batched paths (``batched.py``, ``align``, ``align_words``)
score a padded capture pass with the masked twins of these scorers:
:func:`legacy_weights_batched` (every window at once),
:func:`dynamic_weights_device` and :func:`new_aligner_matrix_device` (one
window at a time, the full capture kept on the device), each bounding a
window by its real frames and token rows. With known heads the capture,
the weights and the DTW cost are one function,
:func:`known_heads_pass`. Every path turns the jump frames into words
with :func:`words_from_jumps` and hangs them on their segments with
:func:`attach_words`. The word splitting and assembly helpers are host
code, carried over because their JAX module imports jax.
"""
import string
from dataclasses import dataclass
from itertools import chain
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...constants import N_FRAMES, N_SAMPLES_PER_TOKEN, TOKENS_PER_SECOND
from ...ops.dtw import dtw_cost, dtw_jumps, dtw_jumps_batched
from ...ops.median import median_filter
from ...ops.mel import log_mel_spectrogram
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
    """(L, max_slots, ..., T, F) selective capture -> (n_sel, ..., T, F):
    the known heads' rows. ``slots``: the (layer, slot) pairs of
    :func:`build_head_capture_table`, or those pairs as an (n_sel, 2)
    tensor on qks's device."""
    slots = torch.as_tensor(slots, device=qks.device)
    return qks[slots[:, 0], slots[:, 1]]


def _next_token_probs(logits: torch.Tensor, tokens: torch.Tensor,
                      eot: int) -> torch.Tensor:
    """(B, T, V) logits + (B, T) realized tokens -> (B, T-1) probability of
    the token that actually follows, soft-maxed over the text vocabulary
    only (``[:eot]``, the reference's timing.py:62-63). Positions whose
    next token is not a text token are discarded by the caller, so the
    clipped index is never read (batched.py:70-94)."""
    probs = torch.softmax(logits[:, :-1, :eot].float(), dim=-1)
    idx = tokens[:, 1:, None].long().clamp(0, eot - 1)
    return probs.gather(-1, idx)[..., 0]


def _next_token_probs_and_ranks(logits: torch.Tensor, tokens: torch.Tensor,
                                eot: int):
    """(B, T, V) logits + (B, T) realized tokens -> the next token's
    probability and its rank in an ascending stable sort of the text
    vocabulary's distribution, both (B, T-1) (batched.py:100-130): the
    count of smaller logits plus the tied logits at a lower index, on raw
    logits (the softmax keeps the order)."""
    lg = logits[:, :-1, :eot].float()
    idx = tokens[:, 1:, None].long().clamp(0, eot - 1)
    v = lg.gather(-1, idx)
    vocab = torch.arange(eot, device=lg.device)
    ranks = ((lg < v).sum(dim=-1, dtype=torch.int32)
             + ((lg == v) & (vocab < idx)).sum(dim=-1, dtype=torch.int32))
    per_token = torch.softmax(lg, dim=-1).gather(-1, idx)[..., 0]
    return per_token, ranks


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


def reflect_src(length, n_frames: int, device=None) -> torch.Tensor:
    """Column sources that write np.pad-'reflect' continuations past a
    crop boundary: column >= length reads column 2*length - 2 - column
    (timing.py:108-121). ``length`` is an int, or a (B, 1) tensor of each
    window's length, which gives (B, n_frames) sources."""
    if isinstance(length, torch.Tensor):
        device = length.device
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


def _zscore_rows(w: torch.Tensor, row_counts) -> torch.Tensor:
    """(..., rows, F) standardized over each window's first ``row_counts``
    rows (an int, or a tensor broadcast against (..., 1, 1)); a column with
    std 0 keeps its centred values (NaNs would poison the DTW)."""
    row_ok = torch.arange(w.shape[-2], device=w.device)[:, None] < row_counts
    count = (row_counts.float() if isinstance(row_counts, torch.Tensor)
             else float(row_counts))
    mean = torch.where(row_ok, w, 0.0).sum(dim=-2, keepdim=True) / count
    var = torch.where(row_ok, (w - mean) ** 2, 0.0).sum(dim=-2, keepdim=True) / count
    std = torch.sqrt(var)
    return (w - mean) / torch.where(std > 0, std, 1.0)


def _masked_softmax(w: torch.Tensor, col_ok: torch.Tensor, qk_scale: float):
    w = torch.where(col_ok, w * qk_scale, -torch.inf)
    return torch.where(col_ok, torch.softmax(w, dim=-1), 0.0)


@torch.inference_mode()
def legacy_weights_batched(qks_sel: torch.Tensor, qk_lens: torch.Tensor,
                           row_counts: torch.Tensor, sot_len: int,
                           qk_scale: float, medfilt_width: int) -> torch.Tensor:
    """The legacy weights of many windows at once (timing.py:168-207),
    meaned over the selected heads. qks_sel (n_sel, B, T, F) bf16; qk_lens
    (B,) real frames and row_counts (B,) real token rows (n_text + 1) per
    window. Columns past a window's frames are masked out of the softmax
    and rows past its tokens out of the normalization; columns >= qk_len
    of the result hold the reflect continuation of the crop, so the kept
    columns equal the reference's crop-first filter. Returns (B, T', F)
    f32: bound each window's DTW at (row_count, qk_len)."""
    w = qks_sel[:, :, sot_len:-1, :].float()
    n_frames = w.shape[-1]
    lens = qk_lens.to(w.device).long()
    col_ok = torch.arange(n_frames, device=w.device) < lens[None, :, None, None]
    w = _masked_softmax(w, col_ok, qk_scale)
    w = _zscore_rows(w, row_counts.to(w.device)[None, :, None, None])
    src = reflect_src(lens[:, None], n_frames)                 # (B, F)
    w = torch.gather(w, -1, src[None, :, None, :].expand(w.shape))
    return median_filter(w, medfilt_width).mean(dim=0)


@torch.inference_mode()
def known_heads_pass(decoder, tokens: torch.Tensor, audio_features: torch.Tensor,
                     capture_index, slots: torch.Tensor, qk_lens: torch.Tensor,
                     row_counts: torch.Tensor, sot_len: int, eot: int):
    """The word-timing pass with known heads, on the device: the
    teacher-forced decoder over ``tokens`` (B, T), right-padded with EOT
    (exact under the causal mask), capturing only the heads of
    ``capture_index``; the next-token probabilities; the heads' rows
    (``slots``, (n_sel, 2) on the device); their legacy weights bounded by
    each row's real frames ``qk_lens`` (B,) and token rows ``row_counts``
    (B,) (n_text + 1); the DTW cost of the negated weights. Returns
    (probabilities (B, T - 1), cost (B, T - sot_len, F + 1)), left on the
    device.

    Upload every host value before the call: a copy from pageable memory
    waits for the work queued ahead of it on its stream."""
    logits, qks = decoder_apply(decoder, tokens, audio_features,
                                capture_qk=True, capture_index=capture_index)
    del audio_features
    probs = _next_token_probs(logits, tokens, eot)
    del logits
    sel = gather_captured_heads(qks.transpose(1, 2), slots)  # (n_sel, B, T, F)
    del qks
    mats = legacy_weights_batched(sel, qk_lens, row_counts, sot_len, 1.0, 7)
    del sel
    return probs, dtw_cost(-mats)


@torch.inference_mode()
def _fused_align_window(model, capture_index, slots: torch.Tensor,
                        audio: torch.Tensor, tokens: torch.Tensor, qk_len: int,
                        row_count: int, *, n_mels: int, sot_len: int, eot: int):
    """A whole single-window timing pass for ``align`` (timing.py:237-279):
    mel -> encoder -> :func:`known_heads_pass` on the model's device, then
    one download of the cost and the probabilities and the traceback on
    the host. JAX compiles this into one program; here it is the same ops
    in a row.

    audio: (1, N_SAMPLES) f32, zero-padded to the full window. tokens:
    (1, T_pad) = sot_seq + no_timestamps + text + eot, right-padded with
    eot. qk_len: real audio frames; row_count: n_text + 1. Returns (jump
    frames (T_pad - sot_len - 1,), next-token probabilities (T_pad - 1,)
    f32)."""
    device = tokens.device
    qk_lens = torch.tensor([qk_len], device=device)
    row_counts = torch.tensor([row_count], device=device)
    mel = log_mel_spectrogram(audio, n_mels)[..., :N_FRAMES]
    probs, cost = known_heads_pass(
        model.decoder, tokens, encoder_apply(model.encoder, mel), capture_index,
        slots, qk_lens, row_counts, sot_len, eot)
    packed = torch.cat([cost.flatten(), probs[0]]).cpu().numpy()
    n_cost = cost.numel()
    jumps = dtw_jumps_batched(packed[:n_cost].reshape(cost.shape),
                              [row_count], [qk_len])[0]
    return jumps, packed[n_cost:]


def dynamic_top_heads(w: torch.Tensor, peaks: Optional[torch.Tensor],
                      heads_count: int) -> torch.Tensor:
    """Per token, the ``heads_count`` heads whose attention lies nearest
    the peak (timing.py:334-382): w (L·H, T', F) soft-maxed weights;
    ``peaks`` (T',) target frames or None for each head's own argmax.
    Returns (T', k) head indices, the smallest score first and the lower
    index first among equal scores, as ``lax.top_k`` of the negated
    scores orders them."""
    frames = torch.arange(w.shape[-1], device=w.device, dtype=torch.float32)
    if peaks is None:
        pk = w.argmax(dim=-1, keepdim=True).float()
    else:
        pk = peaks.to(w.device).float()[None, :, None]
    scores = ((pk - frames).abs() / 1500.0 * w).sum(dim=-1)    # (L·H, T')
    order = torch.sort(-scores.t(), dim=-1, descending=True, stable=True)[1]
    return order[:, :heads_count]


@torch.inference_mode()
def dynamic_weights_device(qks: torch.Tensor, qk_len: int, row_count: int,
                           peaks: Optional[torch.Tensor], sot_len: int,
                           qk_scale: float, medfilt_width: int,
                           heads_count: int) -> torch.Tensor:
    """Dynamic head selection for ONE window on the capture's device
    (timing.py:334-382): the reference's per-token scoring with masking in
    place of cropping (``qk_len`` frames, ``row_count`` token rows in the
    normalization), so the (L, H, T, F) capture stays on the card.
    ``peaks``: (T',) peak targets (the iterated refinement's midpoints of
    the previous jumps) or None. Returns (T', F) f32, meaned over the
    selected heads; columns >= qk_len hold the crop's reflection."""
    L, H, T, F = qks.shape
    heads_count = min(heads_count, L * H)
    w = qks.reshape(L * H, T, F)[:, sot_len:-1, :].float()
    col_ok = torch.arange(F, device=w.device) < qk_len
    w = _masked_softmax(w, col_ok, qk_scale)
    idx = dynamic_top_heads(w, peaks, heads_count)             # (T', k)
    rows = torch.arange(w.shape[1], device=w.device)
    selected = w[idx.t(), rows[None, :]]                        # (k, T', F)
    del w
    selected = _zscore_rows(selected, int(row_count))
    selected = selected[..., reflect_src(qk_len, F, qks.device)]
    return median_filter(selected, medfilt_width).mean(dim=0)


def parse_dynamic_heads(dynamic_heads) -> Tuple[Optional[int], int]:
    """Normalize the ``dynamic_heads`` spec to ``(count, iterations)``.

    Accepts the reference's forms (timing.py:254-265): True -> 6 heads,
    int -> that many heads, 'count' or 'count,iterations' strings. Count
    is None when dynamic selection is off (falsy spec).
    """
    if not dynamic_heads:
        return None, 1
    if dynamic_heads is True:
        return 6, 1
    if isinstance(dynamic_heads, int):
        return int(dynamic_heads), 1
    parts = str(dynamic_heads).split(',')
    return int(parts[0]), (int(parts[1]) if len(parts) > 1 else 1)


def _dynamic_head_weights(qks: np.ndarray, sot_len: int, max_qk_len: int,
                          qk_scale: float, medfilt_width: int,
                          heads_count: int,
                          jump_indices: Optional[np.ndarray]) -> np.ndarray:
    """Reference's dynamic head selection (timing.py:87-103), NumPy host-side
    on the cropped (L*H, T_text, max_qk_len) tensor."""
    L, H, T, F = qks.shape
    heads_count = min(heads_count, L * H)
    w = qks.reshape(L * H, T, F)[:, sot_len:-1, :max_qk_len]
    w = w * qk_scale
    w = np.exp(w - w.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    if jump_indices is None:
        peaks = w.argmax(-1, keepdims=True).astype(np.float64)  # (LH, T', 1)
    else:
        ji = np.pad(jump_indices, (0, 1), constant_values=max_qk_len)
        peaks = (ji[:-1] + (ji[1:] - ji[:-1]) * 0.5)[None, :, None]
    distances = np.abs(peaks - np.arange(w.shape[-1])[None, None, :]) / 1500
    scores = (distances * w).sum(-1)  # (LH, T')
    n_text = w.shape[1]
    selected = np.empty((heads_count, n_text, w.shape[-1]), dtype=w.dtype)
    for i in range(n_text):
        head_idx = np.argsort(scores[:, i])[:heads_count]
        selected[:, i] = w[head_idx, i]
    std = selected.std(axis=-2, keepdims=True)
    mean = selected.mean(axis=-2, keepdims=True)
    # constant rows (e.g. one-token windows) have std 0: normalizing them
    # would produce NaNs that poison the DTW cost matrix
    selected = (selected - mean) / np.where(std > 0, std, 1.0)
    return _np_median_filter(selected, medfilt_width)


def _np_median_filter(x: np.ndarray, width: int) -> np.ndarray:
    if width <= 1 or x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode='reflect')
    windows = np.stack([padded[..., i:i + x.shape[-1]] for i in range(width)],
                       axis=-1)
    return np.median(windows, axis=-1)


def _np_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


# device bytes one head of the 'new' aligner's scoring takes per (row,
# frame): the f32 weights, the median filter's sorted window of 7 (values
# and int64 indices) and its copies
_NEW_ALIGNER_BYTES_PER_CELL = 4 * 8 + 7 * 12 * 2
_NEW_ALIGNER_CHUNK_BYTES = 1 << 30


def new_aligner_head_chunk(n_rows: int, n_frames: int) -> int:
    """Heads scored at once by :func:`new_aligner_matrix`: as many as fit
    in about 1 GiB of working memory (all 640 heads of a large-v3 window
    at once would take tens of GB)."""
    per_head = n_rows * n_frames * _NEW_ALIGNER_BYTES_PER_CELL
    return max(1, _NEW_ALIGNER_CHUNK_BYTES // max(per_head, 1))


def _new_aligner_weights(qks: torch.Tensor, src: torch.Tensor,
                         col_ok: torch.Tensor, qk_scale: float,
                         medfilt_width: int,
                         n_rows: Optional[int] = None) -> torch.Tensor:
    """(n, T, F) raw QK -> the 'new' aligner's f32 head weights: the raw
    columns reflected at the crop (the reference filters the cropped
    capture, timing.py:138-141), median filtered, then soft-maxed over
    the real frames; columns past the crop hold 0, and so do rows from
    ``n_rows`` on (a padded window's pad rows, timing.py:407-413)."""
    w = qks.float()[..., src]
    w = median_filter(w, medfilt_width)
    w = _masked_softmax(w, col_ok, qk_scale)
    if n_rows is not None:
        w[:, n_rows:] = 0.0
    return w


def _new_aligner_scores(w: torch.Tensor, w_colnorm: float, w_rownorm: float,
                        w_coverage: float) -> torch.Tensor:
    """(n, T, F) head weights -> (n,) scores: column and row norms, less
    the coverage penalty (timing.py:458-466)."""
    scores = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    if w_colnorm > 0:
        scores = scores + w_colnorm * torch.linalg.vector_norm(w, dim=-2).sum(-1)
    if w_rownorm > 0:
        scores = scores + w_rownorm * torch.linalg.vector_norm(w, dim=-1).sum(-1)
    if w_coverage > 0:
        coverage = w.sum(dim=1)
        penalty = torch.clamp(coverage, min=0.5).sum(-1) - coverage.shape[-1] * 0.5
        scores = scores - w_coverage * penalty
    return scores


@torch.inference_mode()
def new_aligner_top_heads(qks: torch.Tensor, max_qk_len: int, qk_scale: float,
                          medfilt_width: int, topk: int, w_colnorm: float,
                          w_rownorm: float, w_coverage: float,
                          head_chunk: Optional[int] = None,
                          n_rows: Optional[int] = None):
    """Score all L·H heads of qks (L, H, T, F) by column and row norms (and
    coverage) on qks's device (timing.py:440-466); returns the top-k heads'
    flat indices (L·H order) and their weights (k, T, F) f32, ordered as
    ``lax.top_k`` orders them (score descending, the lower index first on
    ties). Columns >= max_qk_len of the weights are 0.

    The heads are filtered and scored ``head_chunk`` at a time (default:
    :func:`new_aligner_head_chunk`), keeping the best k as the chunks
    pass; each head's score is its own, so the result does not depend on
    the chunk. ``n_rows``: token rows from this one on are zeroed before
    scoring (a batched pass's pad rows)."""
    L, H, T, F = qks.shape
    flat = qks.reshape(L * H, T, F)
    src = reflect_src(max_qk_len, F, qks.device)
    col_ok = torch.arange(F, device=qks.device) < max_qk_len
    chunk = head_chunk or new_aligner_head_chunk(T, F)
    best_scores = best_idx = best_w = None
    for start in range(0, L * H, chunk):
        w = _new_aligner_weights(flat[start:start + chunk], src, col_ok,
                                 qk_scale, medfilt_width, n_rows)
        scores = _new_aligner_scores(w, w_colnorm, w_rownorm, w_coverage)
        idx = torch.arange(start, start + w.shape[0], device=qks.device)
        if best_w is not None:
            w = torch.cat([best_w, w])
            scores = torch.cat([best_scores, scores])
            idx = torch.cat([best_idx, idx])
        # index order first, then a stable sort by score
        order = torch.sort(idx)[1]
        order = order[torch.sort(-scores[order], stable=True)[1]][:topk]
        best_w, best_scores, best_idx = w[order], scores[order], idx[order]
    return best_idx, best_w


def _new_aligner_matrix(qks: torch.Tensor, max_qk_len: int, sot_len: int,
                        qk_scale: float, medfilt_width: int, topk: int,
                        w_colnorm: float, w_rownorm: float, w_coverage: float,
                        head_chunk: Optional[int] = None,
                        n_rows: Optional[int] = None) -> torch.Tensor:
    """'new' aligner on the capture's device (timing.py:440-471): the mean
    of the top-k heads' column-normalized weights
    (:func:`new_aligner_top_heads`), (T - sot_len - 1, F) f32; columns >=
    max_qk_len are 0."""
    _, w = new_aligner_top_heads(qks, max_qk_len, qk_scale, medfilt_width, topk,
                                 w_colnorm, w_rownorm, w_coverage, head_chunk,
                                 n_rows)
    col_norm = torch.linalg.vector_norm(w, dim=-2, keepdim=True)
    matrix = (w / torch.where(col_norm == 0, 1.0, col_norm)).mean(dim=0)
    return matrix[sot_len:-1]


@torch.inference_mode()
def new_aligner_matrix_device(qks: torch.Tensor, qk_len: int, row_count: int,
                              sot_len: int, qk_scale: float, medfilt_width: int,
                              topk: int, w_colnorm: float, w_rownorm: float,
                              w_coverage: float,
                              head_chunk: Optional[int] = None) -> torch.Tensor:
    """The 'new' aligner for ONE window of a batched pass (timing.py:385-427):
    qks (L, H, T, F) whose token rows past sot_len + row_count + 1 (the SOT
    rows, no-timestamps and text rows, EOT) are padding, zeroed before the
    heads are scored. Scored a chunk of heads at a time, as
    :func:`new_aligner_top_heads`. Returns (T - sot_len - 1, F) f32."""
    return _new_aligner_matrix(qks, qk_len, sot_len, qk_scale, medfilt_width,
                               topk, w_colnorm, w_rownorm, w_coverage,
                               head_chunk, n_rows=sot_len + int(row_count) + 1)


def _new_aligner_matrix_host(qks: np.ndarray, max_qk_len: int, sot_len: int,
                             qk_scale: float, medfilt_width: int, topk: int,
                             w_colnorm: float, w_rownorm: float,
                             w_coverage: float) -> np.ndarray:
    """Short-window 'new' aligner on the host: crop BEFORE the median
    filter and softmax, the reference's order (timing.py:474-497)."""
    L, H, T, F = qks.shape
    w = np.asarray(qks, np.float32).reshape(L * H, T, F)[..., :max_qk_len]
    w = _np_median_filter(w, medfilt_width)
    w = _np_softmax(w * qk_scale)
    scores = np.zeros(L * H)
    if w_colnorm > 0:
        scores += w_colnorm * np.linalg.norm(w, axis=-2).sum(-1)
    if w_rownorm > 0:
        scores += w_rownorm * np.linalg.norm(w, axis=-1).sum(-1)
    if w_coverage > 0:
        coverage = w.sum(axis=1)
        scores -= w_coverage * (np.maximum(coverage, 0.5).sum(-1)
                                - coverage.shape[-1] * 0.5)
    top_idxs = np.argsort(-scores)[:topk]
    matrix = w[top_idxs]
    col_norm = np.linalg.norm(matrix, axis=-2, keepdims=True)
    matrix = (matrix / np.where(col_norm == 0, 1.0, col_norm)).mean(axis=0)
    return matrix[sot_len:-1]


def new_aligner_matrix(qks, max_qk_len: int, sot_len: int, qk_scale: float,
                       medfilt_width: int, topk: int, w_colnorm: float,
                       w_rownorm: float, w_coverage: float,
                       head_chunk: Optional[int] = None):
    """'new' aligner matrix cropped to ``max_qk_len`` (timing.py:500-519).

    A tensor stays on its device for any window length (the raw reflect
    continuation reproduces the reference's crop-first median filter);
    the result keeps the full frame width: bound the DTW at
    ``max_qk_len``. NumPy input keeps the reference-order host path for
    short windows."""
    if isinstance(qks, torch.Tensor) or max_qk_len >= qks.shape[-1]:
        m = _new_aligner_matrix(
            torch.as_tensor(qks), max_qk_len, sot_len, qk_scale,
            medfilt_width, topk, w_colnorm, w_rownorm, w_coverage, head_chunk)
        return m if isinstance(qks, torch.Tensor) else m.numpy()
    return _new_aligner_matrix_host(
        np.asarray(qks), max_qk_len, sot_len, qk_scale, medfilt_width, topk,
        w_colnorm, w_rownorm, w_coverage)


def matrix_to_jumps(matrix: torch.Tensor, m: Optional[int] = None) -> np.ndarray:
    """DTW over -matrix (device cost, host traceback) -> per-token jump
    frames; ``m`` bounds the walk to the first m frame columns."""
    n, m_full = matrix.shape
    m = m_full if m is None else min(m, m_full)
    cost = dtw_cost(-matrix.float()).cpu().numpy()
    return dtw_jumps(cost, n, m)


def _extra_model_weights(extra_models, tokenizer, text_tokens, mel, sot_len: int,
                         max_qk_len: int, qk_scale: float, medfilt_width: int,
                         dynamic_count: Optional[int]):
    """Each extra model's capture pass on ``mel`` and its own head weights
    (timing.py:614-640): dynamic, top-1 peaks and never iterated, when the
    main pass is dynamic or the model knows no heads; else its known heads
    through :func:`legacy_head_weights` (a selective capture). Returns
    (host weights, one (n, T', frames) array a model, token probabilities
    a model)."""
    if mel is None:
        raise ValueError('extra_models need the mel segment '
                         '(precomputed audio_features are per-model)')
    weights, probs = [], []
    for em in extra_models:
        device = em.params.decoder.token_emb.device
        if device != mel.device:
            raise ValueError(f'extra model {em.name!r} is on {device}, the mel '
                             f'on {mel.device}: put every model on one device')
        count = dynamic_count or (None if em.alignment_heads is not None else 6)
        if count:
            eqks, eprobs, _ = compute_qks_and_probs(
                em.params, em.dims, tokenizer, text_tokens, mel=mel)
            ew = _dynamic_head_weights(
                eqks[..., :max(max_qk_len, 1)].cpu().float().numpy(), sot_len,
                max_qk_len, qk_scale, medfilt_width, count, None)
        else:
            capture_index, slots = build_head_capture_table(
                em.alignment_heads, em.dims.n_text_layer)
            eqks, eprobs, _ = compute_qks_and_probs(
                em.params, em.dims, tokenizer, text_tokens, mel=mel,
                capture_index=capture_index)
            ew = legacy_head_weights(gather_captured_heads(eqks, slots),
                                     max_qk_len, sot_len, qk_scale,
                                     medfilt_width).cpu().numpy()
        weights.append(ew)
        probs.append(eprobs)
    return weights, probs


def _mix(weights: np.ndarray, extra_weights: List[np.ndarray],
         max_qk_len: int) -> np.ndarray:
    """Head mean over the main and the extra models' weights, each cropped
    to the real frames first (timing.py:662-668, :681-685)."""
    return np.concatenate([w[..., :max_qk_len] for w in [weights] + extra_weights],
                          axis=0).mean(axis=0)


def find_alignment(model, dims, tokenizer, text_tokens: List[int],
                   mel: Optional[torch.Tensor], num_samples: int, *,
                   medfilt_width: int = 7, qk_scale: float = 1.0,
                   token_split=None,
                   audio_features: Optional[torch.Tensor] = None,
                   alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
                   dynamic_heads=None, aligner='legacy',
                   precomputed: Optional[Tuple] = None,
                   extra_models=None) -> List[WordTimingRaw]:
    """Align ``text_tokens`` to audio (timing.py:522-700); per-word raw
    timings. ``model`` is the weights (a :class:`~.model.Whisper`).

    ``aligner``: 'legacy', or 'new' or a dict of the 'new' aligner's
    settings (``topk``, ``w_colnorm``, ``w_rownorm``, ``w_coverage``). The
    legacy aligner uses ``alignment_heads``; with none, and
    ``dynamic_heads`` unset, it selects 6 heads per token dynamically (the
    reference's missing-heads fallback). ``extra_models``
    (:class:`~stable_ts_tpu_torch.loaders.WhisperTorch` on the mel's
    device) each add their own heads' weights to the head mean and their
    token probabilities to the average; the 'new' aligner ignores them,
    as the reference does.

    ``precomputed``: (qks, text_token_probs) from a capture pass the
    caller ran (the batched ``align_words``); no capture pass runs here.
    qks is the full (L, H, T, F) capture or, with the legacy aligner and
    known heads only, the already-selected (n_sel, T, F) head rows; it is
    moved to the model's device."""
    if not (isinstance(aligner, dict) or aligner in ('new', 'legacy')):
        raise ValueError(f'aligner must be "new"/"legacy" or a dict, got {aligner!r}')
    if token_split is None:
        # split with the EOT, which ends as a word of its own: drop it
        words, word_tokens = (x[:-1] for x in tokenizer.split_to_word_tokens(
            list(text_tokens) + [tokenizer.eot]))
    else:
        words, word_tokens = token_split
    sot_len = len(tokenizer.sot_sequence)
    max_qk_len = round(num_samples / N_SAMPLES_PER_TOKEN)
    use_new = aligner != 'legacy'
    new_kwargs = dict(topk=20, w_colnorm=1.0, w_rownorm=1.0, w_coverage=0.0)
    if isinstance(aligner, dict):
        new_kwargs.update(aligner)
        use_new = True
    dynamic_count, iterations = None, 1
    if not use_new:
        if dynamic_heads is None and alignment_heads is None:
            dynamic_heads = True
        dynamic_count, iterations = parse_dynamic_heads(dynamic_heads)
    legacy_known_heads = not use_new and not dynamic_count
    with torch.inference_mode():
        capture_index = slots = None
        if precomputed is not None:
            qks, text_token_probs = precomputed
            qks = torch.as_tensor(qks).to(model.decoder.token_emb.device)
            if qks.ndim == 3 and not legacy_known_heads:
                raise ValueError('pre-selected qks require the legacy aligner '
                                 'with known heads')
        else:
            if legacy_known_heads:
                capture_index, slots = build_head_capture_table(
                    alignment_heads, dims.n_text_layer)
            qks, text_token_probs, _ = compute_qks_and_probs(
                model, dims, tokenizer, text_tokens, mel=mel,
                audio_features=audio_features, capture_index=capture_index)
        extra_weights = []
        if extra_models and not use_new:
            extra_weights, extra_probs = _extra_model_weights(
                extra_models, tokenizer, text_tokens, mel, sot_len, max_qk_len,
                qk_scale, medfilt_width, dynamic_count)
            text_token_probs = np.mean(
                [np.asarray(text_token_probs)] +
                [np.asarray(p) for p in extra_probs], axis=0)
        if use_new:
            matrix = new_aligner_matrix(
                qks, max_qk_len, sot_len, qk_scale, medfilt_width,
                topk=min(int(new_kwargs['topk']),
                         dims.n_text_layer * dims.n_text_head),
                w_colnorm=float(new_kwargs['w_colnorm']),
                w_rownorm=float(new_kwargs['w_rownorm']),
                w_coverage=float(new_kwargs['w_coverage']))
            jump_indices = matrix_to_jumps(matrix, m=max_qk_len)
        elif dynamic_count:
            # crop the frame axis on the device and download the crop in
            # bf16 (the full capture is hundreds of MB at large-v3); the
            # host widens it to f32, as the JAX package does
            crop = qks[..., :max(max_qk_len, 1)].contiguous()
            qks_np = crop.cpu().float().numpy()
            jump_indices = None
            # each pass after the first scores the heads against the
            # midpoints of the previous pass's DTW jumps
            for _ in range(iterations):
                weights = _dynamic_head_weights(
                    qks_np, sot_len, max_qk_len, qk_scale, medfilt_width,
                    dynamic_count, jump_indices)
                matrix = (_mix(weights, extra_weights, max_qk_len)
                          if extra_weights else weights.mean(axis=0))
                jump_indices = matrix_to_jumps(
                    torch.from_numpy(matrix).to(qks.device))
        else:
            if slots is not None:
                qks_sel = gather_captured_heads(qks, slots)
            elif qks.ndim == 3:
                qks_sel = qks      # selected by the caller's capture pass
            else:
                heads = torch.as_tensor(alignment_heads, device=qks.device)
                qks_sel = qks[heads[:, 0], heads[:, 1]]
            weights = legacy_head_weights(qks_sel, max_qk_len, sot_len,
                                          qk_scale, medfilt_width)
            matrix = (torch.from_numpy(_mix(weights.cpu().numpy(), extra_weights,
                                            max_qk_len)).to(qks.device)
                      if extra_weights else weights.mean(dim=0))
            jump_indices = matrix_to_jumps(matrix, m=max_qk_len)
    return words_from_jumps(words, word_tokens, jump_indices, text_token_probs)


def words_from_jumps(words, word_tokens, jump_indices,
                     text_token_probs) -> List[WordTimingRaw]:
    """Per-word raw timings (timing.py:687-700): a word starts at the
    jump frame of its first token and ends at that of the next word's,
    and its probability is the mean of its tokens'. ``words`` and
    ``word_tokens`` leave out the EOT; ``jump_indices`` holds a frame for
    each text token and one for the EOT. ``text_token_probs`` is taken as
    the caller holds it: a list means in f64, an f32 array in f32."""
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens]), (1, 0))
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
    attach_words(segments, alignment, seg_indices, segments[0]['seek'],
                 min_word_dur, prepend_punctuations, append_punctuations)


def attach_words(segments: List[dict], alignment: List[WordTimingRaw],
                 seg_indices: List[int], time_offset: float,
                 min_word_dur: float, prepend_punctuations: str,
                 append_punctuations: str):
    """Append ``alignment``'s words to the ``words`` list of the segment
    each belongs to, in place (timing.py:940-965): the gap-padding entries
    taken out (a segment's first word shorter than ``min_word_dur`` starts
    at the padding before it), punctuation merged into its neighbours, the
    times offset by ``time_offset`` and rounded to ms; then each segment
    with words spans them."""
    alt_beginning_alignment = pop_empty_alignment(alignment, seg_indices)
    merge_punctuations(alignment, prepend_punctuations, append_punctuations)
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
