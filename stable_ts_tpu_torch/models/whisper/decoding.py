"""Greedy Whisper decoding in PyTorch (port of stable_ts_tpu/models/whisper/decoding.py).

The port's slice is greedy decoding at temperature 0 in the JAX package's
``STABLE_TS_TPU_EPI=0`` configuration: each step filters the full (B, V)
f32 logits with :func:`apply_filters` (suppress lists, blank suppression,
Whisper's timestamp grammar, the silence mask, the force-timestamp rule),
takes the argmax, and runs one :func:`~.model.decoder_step` over the int8
self cache and the window's cross K/V. The loop runs on the host, one step
per token, and stops when every row has emitted EOT. Temperature sampling,
beam search, best_of and language detection are not ported yet (ROADMAP.md)
and raise ``NotImplementedError``.
"""
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .model import (decoder_prefill, decoder_step, encoder_apply,
                    fuse_self_qkv, precompute_cross_kv_t)

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
    # n_audio_state >= 1024 else float; True/8 = int8; False = float


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
    """The unfused filter chain of the greedy loop (decoding.py:309-345),
    over (B, V) f32 logits on the model's device. Grammar state per row:
    the last and penultimate sampled tokens and the largest timestamp so
    far (-1 = none)."""

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
        logits = logits + self.suppress + self.ts_silence
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


def _check_supported(options: DecodingOptions) -> None:
    if options.temperature and options.temperature > 0:
        raise NotImplementedError(
            'stable_ts_tpu_torch decodes greedily (temperature=0) only; the '
            'sampling ladder with best_of is still to be ported (ROADMAP.md)')
    if options.beam_size is not None:
        raise NotImplementedError(
            'beam search is still to be ported to stable_ts_tpu_torch '
            '(ROADMAP.md)')
    if options.kv_quant not in (None, False, True, 8):
        raise NotImplementedError(
            f'kv_quant={options.kv_quant!r}: only float or int8 cross K/V is '
            'ported; packed int4 is still to be ported (ROADMAP.md)')


def audio_features(model, dims, mel_or_features: torch.Tensor) -> torch.Tensor:
    x = mel_or_features
    if x.ndim == 2:
        x = x[None]
    if x.shape[-2] == dims.n_mels:  # a mel: encode it
        return encoder_apply(model.encoder, x)
    return x


@torch.inference_mode()
def decode(model, dims, tokenizer, mel_or_features: torch.Tensor,
           options: DecodingOptions = DecodingOptions(),
           ts_silence_mask: Optional[np.ndarray] = None,
           with_features: bool = True) -> List[DecodingResult]:
    """Greedy-decode a batch of 30-s windows; one DecodingResult per row.

    ``ts_silence_mask``: optional bool (B, 1501) or (1501,) — True marks
    timestamp tokens to suppress (the silence-mask rule)."""
    _check_supported(options)
    xa = audio_features(model, dims, mel_or_features)
    device = xa.device
    batch = xa.shape[0]
    dec = model.decoder

    initial_tokens, sot_index, sample_begin = build_initial_tokens(
        tokenizer, options, dims.n_text_ctx)
    sample_len = options.sample_len or (dims.n_text_ctx // 2)
    sample_len = min(sample_len, dims.n_text_ctx - sample_begin - 1)

    suppress = np.zeros(dims.n_vocab, np.float32)
    suppress[build_suppress_list(tokenizer, options)] = _NEG
    suppress[tokenizer.no_timestamps] = _NEG
    blank = np.zeros(dims.n_vocab, np.float32)
    blank[tokenizer.encode(' ') + [tokenizer.eot]] = _NEG
    ts_begin = tokenizer.timestamp_begin
    ts_mask = np.zeros((batch, dims.n_vocab), np.float32)
    if ts_silence_mask is not None:
        sm = np.asarray(ts_silence_mask, bool)
        if sm.ndim == 1:
            sm = sm[None].repeat(batch, 0)
        width = min(sm.shape[-1], dims.n_vocab - ts_begin)
        ts_mask[:, ts_begin:ts_begin + width] = np.where(sm[:, :width], _NEG, 0.0)
    if options.max_initial_timestamp and not options.without_timestamps:
        max_initial_ts_index = round(options.max_initial_timestamp / 0.02)
    else:
        max_initial_ts_index = -1
    filt = LogitFilter(
        dims.n_vocab, tokenizer.eot, ts_begin,
        torch.from_numpy(suppress).to(device), torch.from_numpy(blank).to(device),
        torch.from_numpy(ts_mask).to(device), options.suppress_blank,
        options.without_timestamps, max_initial_ts_index)

    # the cache holds every position the sampler can write, rounded up to 128
    cache_len = min(dims.n_text_ctx,
                    (sample_begin + int(sample_len) + 128) // 128 * 128)
    tokens0 = torch.tensor([initial_tokens] * batch, dtype=torch.long,
                           device=device)
    prefill_logits, cache = decoder_prefill(dec, tokens0, xa, cache_len)
    kv_quant = (dims.n_audio_state >= 1024 if options.kv_quant is None
                else bool(options.kv_quant))
    cross_kv = precompute_cross_kv_t(dec, xa, quantize=kv_quant)
    fused_qkv = fuse_self_qkv(dec)
    no_speech_probs = torch.softmax(prefill_logits[:, sot_index], dim=-1)[
        :, tokenizer.no_speech]

    logits = prefill_logits[:, -1]
    neg1 = torch.full((batch,), -1, dtype=torch.long, device=device)
    last_tok, penult_tok, max_ts = neg1, neg1, neg1
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    sum_logprobs = torch.zeros(batch, dtype=torch.float32, device=device)
    eot = tokenizer.eot
    sampled = []
    for i in range(int(sample_len)):
        filtered = filt(logits, i, last_tok, penult_tok, max_ts)
        next_tok = filtered.argmax(dim=-1)
        tok_logprob = torch.log_softmax(filtered, dim=-1).gather(
            -1, next_tok[:, None])[:, 0]
        sum_logprobs += torch.where(finished, 0.0, tok_logprob)
        next_tok = torch.where(finished, eot, next_tok)
        sampled.append(next_tok)
        max_ts = torch.where(~finished & (next_tok >= ts_begin),
                             torch.maximum(max_ts, next_tok - ts_begin), max_ts)
        finished = finished | (next_tok == eot)
        penult_tok, last_tok = last_tok, next_tok
        if bool(finished.all()):
            break
        logits = decoder_step(dec, next_tok[:, None], sample_begin + i,
                              cross_kv, cache, fused_qkv)

    tokens_np = torch.stack(sampled, dim=1).cpu().numpy()
    sum_np = sum_logprobs.cpu().numpy()
    no_speech_np = no_speech_probs.float().cpu().numpy()
    results = []
    language = tokenizer.language or 'en'
    for b in range(batch):
        seq = tokens_np[b]
        eot_pos = np.flatnonzero(seq == eot)
        seq = seq[:eot_pos[0]] if len(eot_pos) else seq
        text_tokens = [int(t) for t in seq]
        text = tokenizer.decode([t for t in text_tokens if t < eot]).strip()
        results.append(DecodingResult(
            audio_features=xa[b] if with_features else None,
            language=language,
            tokens=text_tokens,
            text=text,
            avg_logprob=float(sum_np[b] / (len(text_tokens) + 1)),
            no_speech_prob=float(no_speech_np[b]),
            temperature=options.temperature,
            compression_ratio=compression_ratio(text),
        ))
    return results
