"""Whisper decoding in PyTorch (port of stable_ts_tpu/models/whisper/decoding.py).

Every strategy of the JAX package's ``decode``, each a host loop of one
:func:`~.model.decoder_step` per token over the int8 self cache and the
window's cross K/V, stopping when nothing is left to sample:

- **greedy** (temperature 0): the fused epilogue of JAX's default TPU path
  (``_fused_greedy_loop``). Step 0 filters the prefill logits with the
  unfused :class:`LogitFilter` and reduces them to the six aggregates;
  every later step hands the decoder's hidden state and the grammar flags
  to the logit-epilogue kernel (``ops/logit_epilogue.py``), which never
  writes the (B, V) logits. :func:`~..ops.logit_epilogue.select_from_aggregates`
  picks the token.
- **sampling** (temperature > 0) with ``best_of`` candidates per window
  (``_sample_loop``): the token is drawn from ``softmax(filtered / T)``
  by inverse CDF, from uniform noise that an explicit ``torch.Generator``
  draws once for every step and every row of the global batch; its
  logprob comes from ``log_softmax(filtered)``; the candidate with the
  best length-normalised logprob wins (``decode_collect``).
- **beam search** (``beam_size``, temperature 0) (``_beam_loop``,
  ``_finalize_beam``): the cache never moves; an ancestry table does.
- :func:`detect_language`.

``decode`` is :func:`decode_collect` of :func:`decode_launch`, the seam of
JAX's ``decode`` (decoding.py:685-928): ``decode_launch`` runs the prefill
and the loop and returns a :class:`PendingDecode` whose outputs (tokens,
sums, beam pools, no-speech probabilities) are still on the device;
``decode_collect`` downloads them and builds the results. The batched
driver (``batched.py``) decodes its window groups through the seam. On a
dp mesh a rank decodes its rows of the batch (``batch_slice``); the noise of
every row is drawn on every rank, so the draws do not depend on the split,
and ``decode_collect`` gathers the outputs over dp before it downloads
them (``PendingDecode.gather``).

A window's best_of candidates or beams share its cross K/V
(``q_per_kv``). The host loop passes the exact position to every step, so
the JAX package's cache-length buckets (``_ctx_buckets``) have no
counterpart. JAX's PRNG cannot be reproduced: ``decode`` seeds a fresh
generator with 0 on each call unless it is given one, as JAX takes
``PRNGKey(0)``.
"""
import math
import zlib
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ... import profiling
from ...ops.logit_epilogue import (fused_logit_aggregates, logit_aggregates,
                                   select_from_aggregates)
from . import step_graph
from .model import (cross_kv_bits, decoder_apply, decoder_prefill, decoder_step,
                    encoder_apply, fuse_self_qkv, precompute_cross_kv_t)

_NEG = -1e9


@dataclass
class DecodingOptions:
    task: str = 'transcribe'
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = '-1'
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    kv_quant: Optional[Union[bool, int]] = None  # cross K/V: None = int8 when
    # n_audio_state >= 1024 else float; True/8 = int8; 4 = packed int4;
    # False = float


@dataclass
class DecodingResult:
    audio_features: Optional[torch.Tensor]
    language: str
    language_probs: Optional[dict] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ''
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


def compression_ratio(text: str) -> float:
    text_bytes = text.encode('utf-8')
    if not text_bytes:
        return 0.0
    return len(text_bytes) / len(zlib.compress(text_bytes))


def build_suppress_list(tokenizer, options: DecodingOptions) -> List[int]:
    suppress = options.suppress_tokens
    if isinstance(suppress, str):
        suppress = [int(t) for t in suppress.split(',')] if suppress else []
    else:
        suppress = list(suppress) if suppress is not None else []
    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tokenizer.non_speech_tokens)
    suppress.extend([tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
                     tokenizer.sot_prev, tokenizer.sot_lm])
    if tokenizer.no_speech is not None:
        suppress.append(tokenizer.no_speech)
    return sorted(set(suppress))


def build_initial_tokens(tokenizer, options: DecodingOptions,
                         n_text_ctx: int) -> Tuple[List[int], int, int]:
    """Return (initial_tokens, sot_index, sample_begin)."""
    tokens = list(tokenizer.sot_sequence)
    if options.without_timestamps:
        tokens.append(tokenizer.no_timestamps)
    if options.prefix is not None:
        prefix = (tokenizer.encode(' ' + options.prefix.strip())
                  if isinstance(options.prefix, str) else list(options.prefix))
        if options.sample_len is not None:
            prefix = prefix[-(n_text_ctx // 2 - options.sample_len):]
        tokens = tokens + prefix
    if options.prompt is not None:
        prompt = (tokenizer.encode(' ' + options.prompt.strip())
                  if isinstance(options.prompt, str) else list(options.prompt))
        tokens = [tokenizer.sot_prev] + prompt[-(n_text_ctx // 2 - 1):] + tokens
    return tokens, tokens.index(tokenizer.sot), len(tokens)


class LogitFilter:
    """The unfused filter chain of the sampling and beam loops
    (decoding.py:309-345), over (B, V) f32 logits on the model's device;
    the greedy loop runs it on step 0 only. Grammar state per row: the
    last and penultimate sampled tokens and the largest timestamp so far
    (-1 = none). ``ts_silence`` may be None (no silence mask)."""

    def __init__(self, n_vocab: int, eot: int, ts_begin: int,
                 suppress: torch.Tensor, blank: torch.Tensor,
                 ts_silence: torch.Tensor, suppress_blank: bool,
                 without_timestamps: bool, max_initial_ts_index: int):
        device = suppress.device
        self.vocab_ids = torch.arange(n_vocab, device=device)
        self.is_ts = self.vocab_ids >= ts_begin
        self.is_text = self.vocab_ids < ts_begin
        self.is_below_eot = self.vocab_ids < eot
        self.ts_begin = ts_begin
        self.suppress = suppress
        self.blank = blank
        self.ts_silence = ts_silence
        self.suppress_blank = suppress_blank
        self.without_timestamps = without_timestamps
        self.max_initial_ts_index = max_initial_ts_index
        self.neg = torch.tensor(_NEG, dtype=torch.float32, device=device)

    def __call__(self, logits, i: int, last_tok, penult_tok, max_ts):
        logits = logits + self.suppress
        if self.ts_silence is not None:
            logits = logits + self.ts_silence
        if self.suppress_blank and i == 0:
            logits = logits + self.blank
        if self.without_timestamps:
            return logits
        neg, is_ts, is_text = self.neg, self.is_ts, self.is_text
        last_was_ts = last_tok >= self.ts_begin
        penult_was_ts = (penult_tok >= self.ts_begin) | (i < 2)
        text_ban = last_was_ts & ~penult_was_ts   # after a lone timestamp
        ts_ban = last_was_ts & penult_was_ts      # after a timestamp pair
        logits = torch.where(ts_ban[:, None] & is_ts, neg, logits)
        logits = torch.where(text_ban[:, None] & self.is_below_eot, neg, logits)
        # timestamps never decrease (strictly increase after a pair)
        has_ts = max_ts >= 0
        ts_floor = torch.where(text_ban, max_ts, max_ts + 1)
        below = self.vocab_ids[None, :] < (self.ts_begin + ts_floor)[:, None]
        logits = torch.where(has_ts[:, None] & below & is_ts, neg, logits)
        if i == 0:
            # the first sampled token is a timestamp within the initial limit
            logits = torch.where(is_text, neg, logits)
            if self.max_initial_ts_index >= 0:
                too_late = self.vocab_ids > self.ts_begin + self.max_initial_ts_index
                logits = torch.where(too_late, neg, logits)
        # timestamps win when their total probability beats every text token
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_logprob = torch.logsumexp(torch.where(is_ts, logprobs, neg), dim=-1)
        max_text = torch.where(is_text, logprobs, neg).amax(dim=-1)
        force_ts = ts_logprob > max_text
        return torch.where(force_ts[:, None] & is_text, neg, logits)


def audio_features(model, dims, mel_or_features: torch.Tensor) -> torch.Tensor:
    x = mel_or_features
    if x.ndim == 2:
        x = x[None]
    if x.shape[-2] == dims.n_mels:  # a mel: encode it
        return encoder_apply(model.encoder, x)
    return x


@torch.inference_mode()
def detect_language(model, dims, tokenizer, mel_or_features: torch.Tensor):
    """(language codes, {code: probability} per row) for a batch of windows:
    the language tokens' softmax of the logits after SOT."""
    xa = audio_features(model, dims, mel_or_features)
    tokens = torch.full((xa.shape[0], 1), tokenizer.sot, dtype=torch.long,
                        device=xa.device)
    logits, _ = decoder_apply(model.decoder, tokens, xa)
    logits = logits[:, 0].cpu().numpy()  # (B, V)
    mask = np.full(logits.shape[-1], -np.inf)
    lang_tokens = np.asarray(tokenizer.all_language_tokens)
    mask[lang_tokens] = 0.0
    logits = logits + mask
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    langs, prob_maps = [], []
    for row in probs:
        best = lang_tokens[row[lang_tokens].argmax()]
        langs.append(tokenizer.all_language_codes[list(lang_tokens).index(best)])
        prob_maps.append({c: float(row[t]) for c, t in
                          zip(tokenizer.all_language_codes, lang_tokens)})
    return langs, prob_maps


def sample_tokens(filtered: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator],
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row drawn from softmax(filtered / temperature) by
    inverse CDF: the first token whose cumulative probability passes
    ``u`` (one uniform [0, 1) value per row; drawn from ``generator`` when
    not given) times the total, so a token of probability 0 is never
    drawn."""
    probs = torch.softmax(filtered / temperature, dim=-1)
    if u is None:
        u = torch.rand(probs.shape[0], generator=generator, device=probs.device)
    cdf = probs.cumsum(dim=-1)
    tok = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    return tok.clamp_(max=probs.shape[-1] - 1)


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first among equal
    values (as jax.lax.top_k; torch.topk leaves tie order open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(-x, axis=1): stable, the lower index first among ties."""
    return torch.argsort(-x, dim=1, stable=True)


def _until_eot(seq: np.ndarray, eot: int) -> np.ndarray:
    eot_pos = np.flatnonzero(seq == eot)
    return seq[:eot_pos[0]] if len(eot_pos) else seq


def _advance_grammar(next_tok, finished, max_ts, ts_begin: int):
    return torch.where(~finished & (next_tok >= ts_begin),
                       torch.maximum(max_ts, next_tok - ts_begin), max_ts)


def _greedy_loop(step, filt, logits, epilogue, *, sample_begin: int,
                 sample_len: int, eot: int, ts_begin: int,
                 with_grammar: bool):
    """Greedy decoding through the logit epilogue (decoding.py:196-279).
    ``epilogue(x, flags)`` -> (B, 6) aggregates of the step's hidden state.
    Returns (sampled tokens (B, n), sum of logprobs (B,))."""
    rows = logits.shape[0]
    neg1 = torch.full((rows,), -1, dtype=torch.long, device=logits.device)
    agg = logit_aggregates(filt(logits, 0, neg1, neg1, neg1), ts_begin)
    last_tok, max_ts = neg1, neg1
    finished = torch.zeros(rows, dtype=torch.bool, device=logits.device)
    sum_logprobs = torch.zeros(rows, dtype=torch.float32, device=logits.device)
    sampled = []
    for i in range(sample_len):
        # a step's span less its one host read is the host queuing its work
        with profiling.span('decode.step'):
            next_tok, tok_logprob = select_from_aggregates(agg, with_grammar)
            sum_logprobs += torch.where(finished, 0.0, tok_logprob)
            next_tok = torch.where(finished, eot, next_tok)
            sampled.append(next_tok)
            max_ts = _advance_grammar(next_tok, finished, max_ts, ts_begin)
            finished = finished | (next_tok == eot)
            if i + 1 == sample_len:
                break
            with profiling.span('decode.sync_wait'):
                done = bool(finished.all())
            if done:
                break
            # the grammar flags of step i + 1 (LogitFilter with last = next_tok)
            last_was_ts = next_tok >= ts_begin
            penult_was_ts = (last_tok >= ts_begin) | (i + 1 < 2)
            text_ban = last_was_ts & ~penult_was_ts
            ts_ban = last_was_ts & penult_was_ts
            ts_floor = torch.where(text_ban, max_ts, max_ts + 1)
            flags = torch.stack([text_ban.long(), ts_ban.long(),
                                 (max_ts >= 0).long(), ts_floor], dim=1).int()
            hidden = step(next_tok[:, None], sample_begin + i, return_hidden=True)
            agg = epilogue(hidden, flags)
            last_tok = next_tok
    profiling.count('decode.steps', len(sampled))
    profiling.count('decode.row_steps', rows * len(sampled))
    return torch.stack(sampled, dim=1), sum_logprobs


def _sample_loop(step, filt, logits, *, temperature: float,
                 noise: torch.Tensor, sample_begin: int,
                 sample_len: int, eot: int, ts_begin: int):
    """Temperature sampling over the unfused filters (decoding.py:368-399).
    ``noise`` (sample_len, B): each step's uniform draws. Returns (sampled
    tokens (B, n), sum of logprobs (B,))."""
    rows = logits.shape[0]
    neg1 = torch.full((rows,), -1, dtype=torch.long, device=logits.device)
    last_tok, penult_tok, max_ts = neg1, neg1, neg1
    finished = torch.zeros(rows, dtype=torch.bool, device=logits.device)
    sum_logprobs = torch.zeros(rows, dtype=torch.float32, device=logits.device)
    sampled = []
    for i in range(sample_len):
        filtered = filt(logits, i, last_tok, penult_tok, max_ts)
        next_tok = sample_tokens(filtered, temperature, None, u=noise[i])
        tok_logprob = torch.log_softmax(filtered, dim=-1).gather(
            -1, next_tok[:, None])[:, 0]
        sum_logprobs += torch.where(finished, 0.0, tok_logprob)
        next_tok = torch.where(finished, eot, next_tok)
        sampled.append(next_tok)
        max_ts = _advance_grammar(next_tok, finished, max_ts, ts_begin)
        finished = finished | (next_tok == eot)
        penult_tok, last_tok = last_tok, next_tok
        if i + 1 == sample_len or bool(finished.all()):
            break
        logits = step(next_tok[:, None], sample_begin + i)
    return torch.stack(sampled, dim=1), sum_logprobs


_BEAM_NEG = -1e30


def _beam_loop(step, filt, logits, *, beam: int, max_candidates: int,
               cache_len: int, sample_begin: int, sample_len: int, eot: int,
               ts_begin: int):
    """Beam search over ``rows // beam`` windows (decoding.py:425-593), token
    for token as the JAX loop: a two-stage top-2k per step, EOT candidates
    into a per-window pool of ``max_candidates``, the next beams from the
    rest, finished windows frozen. The self cache stays where each row
    wrote it; the (rows, cache_len) int32 ancestry table is reshuffled.
    Returns (tokens (rows, sample_len), cumulative logprobs (rows,),
    pool tokens (windows, max_candidates, sample_len), pool scores)."""
    rows = logits.shape[0]
    groups, k, dev = rows // beam, 2 * beam, logits.device
    local = torch.arange(rows, device=dev) % beam
    anc = local[:, None].expand(rows, cache_len).to(torch.int32).contiguous()
    # only beam 0 of each window starts live, so step 0 diversifies them
    cum = torch.where(local == 0, 0.0, _BEAM_NEG).float()
    last_tok = torch.full((rows,), -1, dtype=torch.long, device=dev)
    penult_tok, max_ts = last_tok, last_tok
    group_done = torch.zeros(groups, dtype=torch.bool, device=dev)
    tokens = torch.zeros((rows, sample_len), dtype=torch.long, device=dev)
    fin_tokens = torch.zeros((groups, max_candidates, sample_len),
                             dtype=torch.long, device=dev)
    fin_scores = torch.full((groups, max_candidates), _BEAM_NEG, device=dev)
    first_row = torch.arange(groups, device=dev)[:, None] * beam
    keep_rows = first_row + torch.arange(beam, device=dev)[None]
    for i in range(sample_len):
        filtered = filt(logits, i, last_tok, penult_tok, max_ts)
        row_scores, row_tok = _top_k(torch.log_softmax(filtered, dim=-1), k)
        grp_scores = (cum[:, None] + row_scores).reshape(groups, beam * k)
        grp_tok = row_tok.reshape(groups, beam * k)
        grp_scores = torch.where(group_done[:, None], _BEAM_NEG, grp_scores)
        top_scores, sel = _top_k(grp_scores, k)
        tok = grp_tok.gather(1, sel)
        is_eot = tok == eot
        src_rows = sel // k + first_row                           # (groups, k)

        # EOT candidates join the finished pool (best max_candidates kept)
        cand_tokens = tokens[src_rows]                            # (groups, k, n)
        cand_tokens[:, :, i] = eot
        all_scores = torch.cat([fin_scores,
                                torch.where(is_eot, top_scores, _BEAM_NEG)], 1)
        all_tokens = torch.cat([fin_tokens, cand_tokens], 1)
        order = _argsort_desc(all_scores)[:, :max_candidates]
        fin_scores = all_scores.gather(1, order)
        fin_tokens = all_tokens.gather(
            1, order[:, :, None].expand(-1, -1, sample_len))

        # the next beams: the best non-EOT candidates; finished windows freeze
        live_scores = torch.where(is_eot, _BEAM_NEG, top_scores)
        live_order = _argsort_desc(live_scores)[:, :beam]
        new_cum = live_scores.gather(1, live_order)
        new_tok = tok.gather(1, live_order)
        new_src = src_rows.gather(1, live_order)
        frozen = group_done[:, None]
        new_src = torch.where(frozen, keep_rows, new_src).reshape(-1)
        cum = torch.where(frozen, cum.reshape(groups, beam), new_cum).reshape(-1)
        new_tok = torch.where(frozen, eot, new_tok).reshape(-1)
        group_done = (fin_scores > _BEAM_NEG / 2).all(dim=1)

        tokens = tokens[new_src]
        tokens[:, i] = new_tok
        anc = anc[new_src]
        anc[:, sample_begin + i] = local.to(torch.int32)  # this step's own row
        penult_tok = last_tok[new_src]
        max_ts = max_ts[new_src]
        max_ts = torch.where(new_tok >= ts_begin,
                             torch.maximum(max_ts, new_tok - ts_begin), max_ts)
        last_tok = new_tok
        if i + 1 == sample_len or bool(group_done.all()):
            break
        logits = step(new_tok[:, None], sample_begin + i, anc=anc)
    return tokens, cum, fin_tokens, fin_scores


def _length_score(sum_logprob, n: int, length_penalty: Optional[float]):
    if length_penalty is None:
        return sum_logprob / n
    return sum_logprob / (((5 + n) / 6) ** length_penalty)


def select_best_of(tokens: np.ndarray, sum_logprobs: np.ndarray, n_group: int,
                   eot: int, length_penalty: Optional[float] = None):
    """best_of selection (decoding.py:898-917): for each window of
    ``n_group`` consecutive candidate rows, the row whose sampled tokens
    (cut at the first EOT) have the highest length-normalised logprob; the
    first such row wins a tie. tokens (rows, n) int; sum_logprobs (rows,)
    f32. Returns [(row, tokens, avg_logprob)] per window."""
    chosen = []
    for b in range(len(tokens) // n_group):
        best_row, best_score, best_tokens = None, -np.inf, None
        for r in range(b * n_group, (b + 1) * n_group):
            seq = _until_eot(tokens[r], eot)
            score = _length_score(sum_logprobs[r], len(seq) + 1, length_penalty)
            if score > best_score:
                best_row, best_score, best_tokens = r, score, seq
        chosen.append((best_row, best_tokens,
                       float(sum_logprobs[best_row] / (len(best_tokens) + 1))))
    return chosen


def _finalize_beam(tokens, cum, fin_tokens, fin_scores, beam: int,
                   length_penalty: Optional[float], eot: int):
    """The best finished hypothesis per window, else its best live beam
    (decoding.py:632-681). Returns [(tokens, avg_logprob)] per window."""
    neg_half = -5e29
    chosen = []
    for b in range(fin_scores.shape[0]):
        candidates = [(float(fin_scores[b, c]), _until_eot(fin_tokens[b, c], eot))
                      for c in range(fin_scores.shape[1])
                      if fin_scores[b, c] > neg_half]
        if not candidates:
            candidates = [(float(cum[r]), _until_eot(tokens[r], eot))
                          for r in range(b * beam, (b + 1) * beam)
                          if cum[r] > neg_half]
        best_score, best_seq = -np.inf, np.zeros(0, np.int64)
        for score_sum, seq in candidates:
            score = _length_score(score_sum, len(seq) + 1, length_penalty)
            if score > best_score:
                best_score, best_seq = score, seq
        # avg_logprob from the raw cumulative score of the chosen hypothesis
        chosen_sum = next((s for s, seq in candidates
                           if len(seq) == len(best_seq)
                           and np.array_equal(seq, best_seq)), -np.inf)
        chosen.append((best_seq, float(chosen_sum / (len(best_seq) + 1))))
    return chosen


@dataclass
class PendingDecode:
    """A batched decode whose loop has run but whose outputs are still on
    the model's device (decoding.py:685-706).

    :func:`decode_launch` returns it and :func:`decode_collect` copies the
    outputs down and builds the DecodingResults. JAX's ``decode_launch``
    returns before its ``lax.while_loop`` ends; the port's loops read the
    device every step to stop, so here the seam only defers the download
    and the host's result building, and lets a caller keep the group's
    features (``xa``) for the fallback rungs."""
    kind: str                      # 'sample' | 'beam'
    xa: torch.Tensor               # (B, 1500, d) encoder features
    n_group: int
    options: DecodingOptions
    tokenizer: object
    no_speech_probs: torch.Tensor  # (rows,) on the device
    outputs: tuple                 # the loop's outputs, on the device
    sample_len: int = 0
    # on a dp mesh: all-gathers a tensor of this rank's windows (or rows)
    # over dp, and the global window count to keep of it
    gather: Optional[Callable] = None
    n_windows: int = 0


@torch.inference_mode()
def decode(model, dims, tokenizer, mel_or_features: torch.Tensor,
           options: DecodingOptions = DecodingOptions(),
           ts_silence_mask: Optional[np.ndarray] = None,
           with_features: bool = True,
           generator: Optional[torch.Generator] = None) -> List[DecodingResult]:
    """Decode a batch of 30-s windows; one DecodingResult per row.

    ``ts_silence_mask``: optional bool (B, 1501) or (1501,) — True marks
    timestamp tokens to suppress (the silence-mask rule). ``generator``
    draws the samples at temperature > 0; None means a fresh generator on
    the model's device seeded with 0."""
    return decode_collect(decode_launch(
        model, dims, tokenizer, mel_or_features, options,
        ts_silence_mask=ts_silence_mask, generator=generator),
        with_features=with_features)


@torch.inference_mode()
def decode_launch(model, dims, tokenizer, mel_or_features: torch.Tensor,
                  options: DecodingOptions = DecodingOptions(),
                  ts_silence_mask: Optional[np.ndarray] = None,
                  generator: Optional[torch.Generator] = None,
                  batch_slice: Optional[Tuple[int, int]] = None) -> PendingDecode:
    """Run a batched decode and keep its outputs on the device; see
    :class:`PendingDecode`. Pass encoder features to reuse them across the
    temperature fallback's rungs (decoding.py:724-868). ``batch_slice``: (the
    global index of this batch's first window, the global window count)
    when the batch is one rank's share of a larger one (padded windows
    past the count repeat the last); the sampler then draws every global
    row's noise and keeps this batch's."""
    xa = audio_features(model, dims, mel_or_features)
    with profiling.span('decode.prefill'):
        device = xa.device
        batch = xa.shape[0]
        dec = model.decoder
        use_beam = options.beam_size is not None and options.temperature == 0
        if use_beam:
            n_group = options.beam_size
        else:
            n_group = (options.best_of
                       if options.best_of and options.temperature > 0 else 1)
        rows = batch * n_group

        initial_tokens, sot_index, sample_begin = build_initial_tokens(
            tokenizer, options, dims.n_text_ctx)
        sample_len = options.sample_len or (dims.n_text_ctx // 2)
        sample_len = int(min(sample_len, dims.n_text_ctx - sample_begin - 1))

        suppress = np.zeros(dims.n_vocab, np.float32)
        suppress[build_suppress_list(tokenizer, options)] = _NEG
        suppress[tokenizer.no_timestamps] = _NEG
        blank = np.zeros(dims.n_vocab, np.float32)
        blank[tokenizer.encode(' ') + [tokenizer.eot]] = _NEG
        ts_begin, eot = tokenizer.timestamp_begin, tokenizer.eot
        ts_mask = None
        if ts_silence_mask is not None:
            sm = np.asarray(ts_silence_mask, bool)
            if sm.ndim == 1:
                sm = sm[None].repeat(batch, 0)
            sm = np.repeat(sm, n_group, axis=0)
            width = min(sm.shape[-1], dims.n_vocab - ts_begin)
            mask = np.zeros((rows, dims.n_vocab), np.float32)
            mask[:, ts_begin:ts_begin + width] = np.where(sm[:, :width], _NEG, 0.0)
            ts_mask = torch.from_numpy(mask).to(device)
        if options.max_initial_timestamp and not options.without_timestamps:
            max_initial_ts_index = round(options.max_initial_timestamp / 0.02)
        else:
            max_initial_ts_index = -1
        suppress_t = torch.from_numpy(suppress).to(device)
        filt = LogitFilter(
            dims.n_vocab, eot, ts_begin, suppress_t,
            torch.from_numpy(blank).to(device), ts_mask, options.suppress_blank,
            options.without_timestamps, max_initial_ts_index)

        # the cache holds every position the sampler can write, rounded up to 128
        cache_len = min(dims.n_text_ctx, (sample_begin + sample_len + 128) // 128 * 128)
        tokens0 = torch.tensor([initial_tokens] * rows, dtype=torch.long,
                               device=device)
        kv_quant = (dims.n_audio_state >= 1024 if options.kv_quant is None
                    else options.kv_quant)
        # the greedy step replays a CUDA graph where it can (step_graph.py):
        # the prefill then fills the graph's self cache, which may be longer
        runner = key = None
        if (not use_beam and options.temperature == 0 and step_graph.graphable(
                dec, device, return_hidden=True, q_per_kv=n_group)):
            runner, key = step_graph.kept(
                dec, rows, (xa.shape[1], cross_kv_bits(kv_quant), xa.dtype), cache_len)
        # every row of a window group prefills from the window's features; the
        # cross K/V are kept once per window
        xa_rows = xa.repeat_interleave(n_group, dim=0) if n_group > 1 else xa
        prefill_logits, cache = decoder_prefill(
            dec, tokens0, xa_rows, cache_len, out=runner.cache if runner else None)
        cross_kv = precompute_cross_kv_t(dec, xa, quantize=kv_quant)
        if key is not None and runner is None:
            runner = dec._step_graph = step_graph.StepGraph(dec, key, cache)
        step = partial(decoder_step, dec, cross_kv=cross_kv, cache=cache,
                       fused_qkv=runner.fused_qkv if runner else fuse_self_qkv(dec),
                       q_per_kv=n_group)
        # stays on the device: a download here would wait for the prefill
        no_speech = torch.softmax(prefill_logits[:, sot_index], dim=-1)[
            :, tokenizer.no_speech].float()
        logits = prefill_logits[:, -1]
        loop = dict(sample_begin=sample_begin, sample_len=sample_len, eot=eot,
                    ts_begin=ts_begin)
        pending = partial(PendingDecode, xa=xa, n_group=n_group,
                          options=options, tokenizer=tokenizer,
                          no_speech_probs=no_speech, sample_len=sample_len)

    if use_beam:
        max_candidates = int(math.ceil(n_group * (options.patience or 1.0)))
        return pending(kind='beam', outputs=_beam_loop(
            step, filt, logits, beam=n_group, max_candidates=max_candidates,
            cache_len=cache_len, **loop))
    if options.temperature == 0:
        with_grammar = not options.without_timestamps
        emb = dec.token_emb

        def epilogue(x, flags):
            return fused_logit_aggregates(x, emb, suppress_t, ts_mask, flags,
                                          ts_begin, eot, with_grammar)

        outputs = _greedy_loop(partial(step, graph=runner), filt, logits, epilogue,
                               with_grammar=with_grammar, **loop)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        first, n_windows = batch_slice or (0, batch)
        noise = torch.rand((sample_len, n_windows * n_group),
                           generator=generator, device=device)
        window = (first + torch.arange(batch, device=device)).clamp_(
            max=n_windows - 1)
        noise = noise[:, (window[:, None] * n_group + torch.arange(
            n_group, device=device)).reshape(-1)]
        outputs = _sample_loop(step, filt, logits,
                               temperature=options.temperature,
                               noise=noise, **loop)
    return pending(kind='sample', outputs=outputs)


def _gather_outputs(pending: PendingDecode):
    """(outputs, no-speech probabilities) of a rank's share gathered over
    dp and cut to the global windows. Each rank's loop stops when its own
    rows are done, so the sampled tokens are first padded with EOT to
    ``sample_len`` (what follows a row's first EOT is never read)."""
    gather, n = pending.gather, pending.n_windows
    rows = n * pending.n_group
    if pending.kind == 'beam':
        tokens, cum, fin_tokens, fin_scores = pending.outputs
        outputs = (gather(tokens)[:rows], gather(cum)[:rows],
                   gather(fin_tokens)[:n], gather(fin_scores)[:n])
    else:
        tokens, sum_logprobs = pending.outputs
        tokens = torch.nn.functional.pad(
            tokens, (0, pending.sample_len - tokens.shape[1]),
            value=pending.tokenizer.eot)
        outputs = (gather(tokens)[:rows], gather(sum_logprobs)[:rows])
    return outputs, gather(pending.no_speech_probs)[:rows]


def decode_collect(pending: PendingDecode,
                   with_features: bool = True) -> List[DecodingResult]:
    """Copy a :class:`PendingDecode`'s outputs to the host and build its
    DecodingResults (decoding.py:871-928). ``with_features=False`` leaves
    ``audio_features`` None: the batched driver keeps the group's features
    itself."""
    with profiling.span('decode.collect'):
        options, tokenizer = pending.options, pending.tokenizer
        n_group, eot = pending.n_group, tokenizer.eot
        outputs, no_speech = pending.outputs, pending.no_speech_probs
        if pending.gather is not None:
            outputs, no_speech = _gather_outputs(pending)
        no_speech = no_speech.cpu().numpy()
        profiling.read_device_times()
        if pending.kind == 'beam':
            tokens_np, cum_np, fin_tok_np, fin_sc_np = (
                t.cpu().numpy() for t in outputs)
            chosen = [(b * n_group, seq, avg) for b, (seq, avg) in enumerate(
                _finalize_beam(tokens_np, cum_np, fin_tok_np, fin_sc_np, n_group,
                               options.length_penalty, eot))]
        else:
            tokens, sum_logprobs = outputs
            chosen = select_best_of(tokens.cpu().numpy(), sum_logprobs.cpu().numpy(),
                                    n_group, eot, options.length_penalty)

        xa = pending.xa if with_features else None
        results = []
        language = tokenizer.language or 'en'
        for b, (row, seq, avg_logprob) in enumerate(chosen):
            text_tokens = [int(t) for t in seq]
            text = tokenizer.decode([t for t in text_tokens if t < eot]).strip()
            results.append(DecodingResult(
                audio_features=xa[b] if xa is not None else None,
                language=language,
                tokens=text_tokens,
                text=text,
                avg_logprob=avg_logprob,
                no_speech_prob=float(no_speech[row]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
            ))
    return results
