"""Whisper encoder-decoder in PyTorch (port of stable_ts_tpu/models/whisper/model.py).

Modules hold the weights; the applies are functions over them, named after
their JAX counterparts so a reader finds each one's twin:

- :func:`encoder_apply`: conv stem, then blocks whose self-attention is
  the flash kernel (``ops/flash_attn.py``);
- :func:`decoder_apply`: the teacher-forced pass of the word-timing step,
  with flash cross-attention and the selected heads' raw QK recomputed in
  f32 and stored as bf16 (model.py:377-383, 601-607);
- :func:`decoder_prefill` and :func:`decoder_step`: the incremental
  decoder over an int8 row cache (or, for ``locate``'s confirmation
  decode, a float one) that the step updates IN PLACE (JAX threads it
  through the scan carry instead), with the decode-attention
  kernels (``ops/self_attn.py``, ``ops/cross_attn.py``); the step also
  serves best_of groups and beams (``q_per_kv``, ``anc``) and can return
  the hidden state for the logit epilogue (``ops/logit_epilogue.py``);
- :func:`precompute_cross_kv_t`: per-layer cross-attention K/V once per
  window, in the row-major layout the cross kernel reads (float, int8 or
  packed int4);
- :meth:`TextDecoder.vocab_logits`: the tied-embedding logits, through the
  vocab-projection kernel (``ops/vocab_proj.py``) at decode-step shapes.

A ``dq`` model's q/k/v/out/fc1/fc2 linears are
:class:`~.quantization.QuantizedLinear` modules (int8 weights through the
weight-only kernel, ``ops/woq_matmul.py``); every apply below calls them as
modules, so the float and the quantized model share one code path.

Numerics follow the JAX package: layer norm in f32 with eps 1e-5, exact-erf
GELU, f32 accumulation, attention scores and logits in f32, and int8
quantization with half-to-even rounding. Linear weights are stored in
torch's (out, in) layout; :mod:`.convert` transposes the JAX (in, out) ones.
"""
import math
from functools import partial
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...ops.cross_attn import cross_attn_decode, pack_int4
from ...ops.flash_attn import flash_attention
from ...ops.self_attn import self_attn_decode
from ...ops.vocab_proj import MAX_ROWS, MIN_VOCAB, vocab_proj
from .dims import ModelDimensions
from .quantization import QuantizedLinear, quantize_rows


# -- primitives ----------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32, cast back to x's dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form, as jax.nn.gelu(approximate=False)


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's encoder positional embedding (sin / cos halves)."""
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def qkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_head: int, mask: Optional[torch.Tensor] = None,
                  return_qk: bool = False):
    """Plain masked attention (model.py:183-204): q and k each scaled by
    d_head**-0.25 in their dtype, scores and softmax in f32. Returns
    (out (B, T, d) in v's dtype, f32 scores (B, H, T, S) or None)."""
    b, t, d = q.shape
    s = k.shape[1]
    dh = d // n_head
    scale = dh ** -0.25
    qh = q.reshape(b, t, n_head, dh).transpose(1, 2) * scale
    kh = k.reshape(b, s, n_head, dh).transpose(1, 2) * scale
    vh = v.reshape(b, s, n_head, dh).transpose(1, 2)
    logits = qh.float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = (w.float() @ vh.float()).to(v.dtype)
    out = out.transpose(1, 2).reshape(b, t, d)
    return out, (logits if return_qk else None)


# -- modules -------------------------------------------------------------------------------

class LayerNorm(nn.Module):
    def __init__(self, d: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, **factory))
        self.bias = nn.Parameter(torch.empty(d, **factory))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, n_head: int, **factory):
        super().__init__()
        self.n_head = n_head
        self.q = nn.Linear(d, d, **factory)
        self.k = nn.Linear(d, d, bias=False, **factory)  # Whisper: no key bias
        self.v = nn.Linear(d, d, **factory)
        self.out = nn.Linear(d, d, **factory)


class MLP(nn.Module):
    def __init__(self, d: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d, **factory)
        self.fc2 = nn.Linear(4 * d, d, **factory)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, n_head: int, cross: bool, **factory):
        super().__init__()
        self.attn_ln = LayerNorm(d, **factory)
        self.attn = MultiHeadAttention(d, n_head, **factory)
        if cross:
            self.cross_attn_ln = LayerNorm(d, **factory)
            self.cross_attn = MultiHeadAttention(d, n_head, **factory)
        self.mlp_ln = LayerNorm(d, **factory)
        self.mlp = MLP(d, **factory)


class _Stack(nn.Module):
    """The head layout of one stack. ``n_head`` counts the heads this
    module computes: all of them, or this rank's after ``shard_params``,
    which also sets ``head_offset`` (its first head) and ``tp_group`` (the
    group its row amaxes and head captures reduce over; None when
    unsharded). ``d_head`` and ``n_head_total`` stay the model's."""

    def _init_heads(self, d: int, n_head: int):
        self.n_head = self.n_head_total = n_head
        self.d_head = d // n_head
        self.head_offset = 0
        self.tp_group = None


class AudioEncoder(_Stack):
    def __init__(self, dims: ModelDimensions, **factory):
        super().__init__()
        d = dims.n_audio_state
        self._init_heads(d, dims.n_audio_head)
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1, **factory)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **factory)
        self.pos_emb = nn.Parameter(torch.empty(dims.n_audio_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_audio_head, False, **factory)
            for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d, **factory)


class TextDecoder(_Stack):
    def __init__(self, dims: ModelDimensions, **factory):
        super().__init__()
        d = dims.n_text_state
        self._init_heads(d, dims.n_text_head)
        self.token_emb = nn.Parameter(torch.empty(dims.n_vocab, d, **factory))
        self.pos_emb = nn.Parameter(torch.empty(dims.n_text_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_text_head, True, **factory)
            for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d, **factory)
        self._emb_f32 = None  # (token_emb version, f32 copy)

    def vocab_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding projection x @ token_emb^T with f32 logits. A
        decode step's 2-D x of at most 256 rows against a vocabulary of at
        least 2048 goes to the vocab-projection kernel (its twin on the
        CPU), the shapes the JAX package sends its kernel (model.py:150).
        Other shapes (prefill, the teacher-forced pass) multiply by an exact
        f32 copy of a bf16 embedding, which equals bf16 products summed in
        f32 — what the JAX package's ``preferred_element_type=float32``
        computes. The copy is cached (once per weight version) only when no
        gradient is wanted; when one is, the product is differentiable, so
        the tied embedding gets the projection's gradient as well as the
        lookup's."""
        if (x.dim() == 2 and x.shape[0] <= MAX_ROWS
                and self.token_emb.shape[0] >= MIN_VOCAB):
            return vocab_proj(x, self.token_emb)
        w = self.token_emb
        if torch.is_grad_enabled() and w.requires_grad:
            return x.float() @ w.float().t()
        if w.dtype != torch.float32:
            version = w._version
            if self._emb_f32 is None or self._emb_f32[0] != version:
                self._emb_f32 = (version, w.detach().float())
            w = self._emb_f32[1]
        return x.float() @ w.t()


class Whisper(nn.Module):
    def __init__(self, dims: ModelDimensions, **factory):
        super().__init__()
        self.dims = dims
        self.mesh = None  # the (dp, tp) mesh of parallel.shard_params
        self.encoder = AudioEncoder(dims, **factory)
        self.decoder = TextDecoder(dims, **factory)


# -- encoder -------------------------------------------------------------------------------

def encoder_apply(encoder: AudioEncoder, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> (B, 1500, d)."""
    x = mel.to(encoder.conv1.weight.dtype)
    x = gelu(encoder.conv1(x))
    x = gelu(encoder.conv2(x))
    x = (x.transpose(1, 2) + encoder.pos_emb).to(x.dtype)
    n_head = encoder.n_head
    scale = encoder.d_head ** -0.5
    for blk in encoder.blocks:
        h = blk.attn_ln(x)
        a = blk.attn
        x = x + a.out(flash_attention(a.q(h), a.k(h), a.v(h), n_head, scale))
        x = x + blk.mlp(blk.mlp_ln(x))
    return encoder.ln_post(x)


# -- decoder -------------------------------------------------------------------------------

def _embed(decoder: TextDecoder, tokens: torch.Tensor, offset: int = 0):
    n_tok = tokens.shape[1]
    x = decoder.token_emb[tokens] + decoder.pos_emb[offset:offset + n_tok]
    return x.to(decoder.token_emb.dtype)


def _causal_mask(n_tok: int, device) -> torch.Tensor:
    return torch.full((n_tok, n_tok), -math.inf, device=device).triu(1)


def decoder_apply(decoder: TextDecoder, tokens: torch.Tensor, xa: torch.Tensor,
                  capture_qk: bool = False,
                  capture_index=None):
    """Teacher-forced decoder pass.

    tokens (B, T) int64; xa (B, S, d). Returns (logits (B, T, V) f32,
    cross_qk (L, B, slots, T, S) bf16 or None). ``capture_index``
    (L, slots), an array or a tensor on the tokens' device, picks the heads
    whose raw QK is captured per layer (see
    timing.build_head_capture_table; padding slots repeat head 0); None
    captures every head. The captured QK is recomputed from the selected
    heads only, q and k each scaled by d_head**-0.25, in f32. On a tp
    shard each rank computes the slots of the heads it holds, zeros in the
    others, and the sum over the tp group is the whole capture on every
    rank."""
    b, n_tok = tokens.shape
    n_head, dh = decoder.n_head, decoder.d_head
    if capture_qk:
        # uploaded before any kernel is queued: a copy from pageable memory
        # waits for the stream it is queued on
        n_total = decoder.n_head_total
        heads = (torch.arange(n_total, device=tokens.device)[None].expand(
                     len(decoder.blocks), n_total) if capture_index is None
                 else torch.as_tensor(capture_index, dtype=torch.long,
                                      device=tokens.device))
        local = heads - decoder.head_offset
        owned = (local >= 0) & (local < n_head)
        local = local.clamp(0, n_head - 1)
    x = _embed(decoder, tokens)
    causal = _causal_mask(n_tok, x.device)
    qks = []
    for layer, blk in enumerate(decoder.blocks):
        h = blk.attn_ln(x)
        a = blk.attn
        attn_out, _ = qkv_attention(a.q(h), a.k(h), a.v(h), n_head, mask=causal)
        x = x + a.out(attn_out)
        ca = blk.cross_attn
        q = ca.q(blk.cross_attn_ln(x))
        k = ca.k(xa)
        x = x + ca.out(flash_attention(q, k, ca.v(xa), n_head, dh ** -0.5))
        x = x + blk.mlp(blk.mlp_ln(x))
        if capture_qk:
            qh = q.reshape(b, n_tok, n_head, dh).transpose(1, 2)[:, local[layer]]
            kh = k.reshape(b, -1, n_head, dh).transpose(1, 2)[:, local[layer]]
            scale = dh ** -0.25
            qk = (qh * scale).float() @ (kh * scale).float().transpose(-1, -2)
            if decoder.tp_group is not None:
                qk = torch.where(owned[layer][:, None, None], qk, 0.0)
                dist.all_reduce(qk, group=decoder.tp_group)
            qks.append(qk.to(torch.bfloat16))
    x = decoder.ln(x)
    logits = decoder.vocab_logits(x)
    return logits, (torch.stack(qks) if capture_qk else None)


def decoder_prefill(decoder: TextDecoder, tokens: torch.Tensor,
                    xa: torch.Tensor, n_text_ctx: int, int8_cache: bool = True):
    """Teacher-forced pass over the initial tokens that also fills the row
    cache for positions [0, T). Returns (logits (B, T, V) f32, cache).
    ``int8_cache`` (the decode loops' layout): {'k', 'v': int8 (L, B,
    n_text_ctx, d); 'ks', 'vs': f32 (L, B, n_text_ctx)}, unwritten rows
    zero with scale 1 (model.py:839-850). Otherwise {'k', 'v'} in the
    activations' dtype, unwritten rows zero: the cache JAX's prefill keeps
    by default, which ``locate`` decodes over (model.py:893-905)."""
    b, n_tok = tokens.shape
    n_head = decoder.n_head
    n_layers = len(decoder.blocks)
    x = _embed(decoder, tokens)
    dev = x.device
    shape = (n_layers, b, n_text_ctx, n_head * decoder.d_head)
    if int8_cache:
        cache = {
            'k': torch.zeros(shape, dtype=torch.int8, device=dev),
            'v': torch.zeros(shape, dtype=torch.int8, device=dev),
            'ks': torch.ones(shape[:3], dtype=torch.float32, device=dev),
            'vs': torch.ones(shape[:3], dtype=torch.float32, device=dev),
        }
    else:
        cache = {'k': torch.zeros(shape, dtype=x.dtype, device=dev),
                 'v': torch.zeros(shape, dtype=x.dtype, device=dev)}
    causal = _causal_mask(n_tok, dev)
    for layer, blk in enumerate(decoder.blocks):
        h = blk.attn_ln(x)
        a = blk.attn
        k, v = a.k(h), a.v(h)
        attn_out, _ = qkv_attention(a.q(h), k, v, n_head, mask=causal)
        x = x + a.out(attn_out)
        ca = blk.cross_attn
        cross_out, _ = qkv_attention(ca.q(blk.cross_attn_ln(x)), ca.k(xa),
                                     ca.v(xa), n_head)
        x = x + ca.out(cross_out)
        x = x + blk.mlp(blk.mlp_ln(x))
        _write_rows(cache, layer, slice(0, n_tok), k, v, decoder.tp_group)
    x = decoder.ln(x)
    return decoder.vocab_logits(x), cache


def _write_rows(cache: dict, layer: int, at, k: torch.Tensor, v: torch.Tensor,
                group=None):
    """Store K/V rows at cache positions ``at`` of ``layer``: quantized to
    int8 with their scales when the cache has them (K and V in one call,
    the amax of a row split over tp reduced over ``group`` in one
    all-reduce), else as they are."""
    if 'ks' in cache:
        qt, sc = quantize_rows(torch.stack([k, v]), group=group)
        cache['k'][layer, :, at], cache['v'][layer, :, at] = qt[0], qt[1]
        cache['ks'][layer, :, at], cache['vs'][layer, :, at] = sc[0], sc[1]
    else:
        cache['k'][layer, :, at], cache['v'][layer, :, at] = k, v


def fuse_self_qkv(decoder: TextDecoder):
    """Per layer, one projection of the self-attention q/k/v weights
    concatenated (model.py:459-484): one product per layer per token
    instead of three. k has no bias; its slot is zeros. A quantized layer
    concatenates the int8 weights and their per-output scales, which is
    exact. On a tp shard the three hold this rank's heads, and so does
    their product. Each entry is a callable x -> (..., 3 * n_head * d_head)."""
    fused = []
    for blk in decoder.blocks:
        q, k, v = (getattr(lin, 'inner', lin)
                   for lin in (blk.attn.q, blk.attn.k, blk.attn.v))
        bias = torch.cat([q.bias, torch.zeros_like(q.bias), v.bias])
        if isinstance(q, QuantizedLinear):
            fused.append(QuantizedLinear(
                torch.cat([q.weight, k.weight, v.weight], dim=0),
                torch.cat([q.scale, k.scale, v.scale]), bias))
        else:
            w = torch.cat([q.weight, k.weight, v.weight], dim=0)
            fused.append(partial(F.linear, weight=w, bias=bias))
    return fused


def precompute_cross_kv_t(decoder: TextDecoder, xa: torch.Tensor,
                          quantize=False):
    """Cross-attention K/V of every layer, once per window, in the layout
    the cross kernel reads (model.py:487-547, re-laid out row-major).

    ``quantize``: False keeps xa's dtype; True or 8 stores int8 with
    per-position scales (amax / 127 over d); 4 stores the int4 grid
    ([-7, 7], amax / 7) packed two dims per byte (:func:`pack_int4`); any
    other width in 2..8 stores its grid unpacked, as the JAX package does.
    Returns {'kv': (L, B, 2, S, d) (or (L, B, 2, S, d / 2) bytes for int4),
    'sc': (L, B, 2, S) f32 per-position scales (ones when float), 's': S,
    'bits': the stored width (0 = float)}. On a tp shard ``d`` is this
    rank's heads' width, and each position's amax is reduced over the tp
    group, so its scale and codes are the whole row's."""
    b, s = xa.shape[:2]
    d = decoder.n_head * decoder.d_head
    n_layers = len(decoder.blocks)
    bits = 0 if not quantize else (8 if quantize is True else int(quantize))
    if bits and not 2 <= bits <= 8:
        raise ValueError(f'cross K/V quantization takes 2 to 8 bits, got {bits}')
    width = d // 2 if bits == 4 else d
    dtype = torch.int8 if bits else xa.dtype
    kv = torch.empty((n_layers, b, 2, s, width), dtype=dtype, device=xa.device)
    sc = torch.ones((n_layers, b, 2, s), dtype=torch.float32, device=xa.device)
    for layer, blk in enumerate(decoder.blocks):
        ca = blk.cross_attn
        for slot, t in enumerate((ca.k(xa), ca.v(xa))):
            if bits:
                q, sc[layer, :, slot] = quantize_rows(t, bits,
                                                      group=decoder.tp_group)
                kv[layer, :, slot] = pack_int4(q) if bits == 4 else q
            else:
                kv[layer, :, slot] = t
    return {'kv': kv, 'sc': sc, 's': s, 'bits': bits}


def decoder_step(decoder: TextDecoder, tokens: torch.Tensor, pos: int,
                 cross_kv: dict, cache: dict, fused_qkv: List,
                 q_per_kv: int = 1, anc: Optional[torch.Tensor] = None,
                 return_hidden: bool = False) -> torch.Tensor:
    """One decode step at position ``pos``. tokens (B, 1). Writes this
    position's K/V rows into ``cache`` in place (int8 when the cache holds
    scales, as :func:`decoder_prefill` made it), then attends keys
    j <= pos with the self-decode kernel and the window's cross K/V with
    the cross-decode kernel. Returns logits (B, V) f32, or with
    ``return_hidden`` the post-LN state (B, d) that the logit epilogue
    consumes.

    ``q_per_kv``: consecutive rows sharing one window of ``cross_kv`` (the
    beams or best_of candidates of a window; cross K/V is stored once per
    window). ``anc``: the beam layout's (B, C) int32 ancestry table — row
    r attends its window group's cache row ``anc[r, j]`` at position j;
    ``anc[:, pos]`` must be each row's own local index, since this step
    writes each row's K/V in place."""
    n_head = decoder.n_head
    d = n_head * decoder.d_head        # this rank's heads' width
    q_scale = decoder.d_head ** -0.5
    x = _embed(decoder, tokens, offset=pos)
    cross_bits = 4 if cross_kv['bits'] == 4 else 8
    for layer, blk in enumerate(decoder.blocks):
        qkv = fused_qkv[layer](blk.attn_ln(x))
        q_proj, new_k, new_v = qkv[:, 0].split(d, dim=-1)
        _write_rows(cache, layer, pos, new_k, new_v, decoder.tp_group)
        ks, vs = ((cache['ks'][layer], cache['vs'][layer]) if 'ks' in cache
                  else (None, None))
        ctx = self_attn_decode(q_proj.float() * q_scale, cache['k'][layer],
                               cache['v'][layer], ks, vs, pos, n_head, anc=anc,
                               q_per_kv=q_per_kv)
        x = x + blk.attn.out(ctx[:, None].to(x.dtype))
        ca = blk.cross_attn
        q = ca.q(blk.cross_attn_ln(x))[:, 0].float() * q_scale
        ctx = cross_attn_decode(q, cross_kv['kv'], cross_kv['sc'], layer,
                                cross_kv['s'], n_head, q_per_kv=q_per_kv,
                                bits=cross_bits)
        x = x + ca.out(ctx[:, None].to(x.dtype))
        x = x + blk.mlp(blk.mlp_ln(x))
    x = decoder.ln(x)[:, 0]
    return x if return_hidden else decoder.vocab_logits(x)


# -- random weights ------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """The device a model was asked for; ``cuda`` without a GPU raises."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} was asked for, but CUDA is not '
                           'available on this machine')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device}')
    return device


@torch.no_grad()
def init_params(dims: ModelDimensions, seed: int = 0,
                dtype: torch.dtype = torch.float32, device='cuda') -> Whisper:
    """A random-weight model drawn from a ``torch.Generator`` on ``device``
    (the same distributions as the JAX package's init_params, not the same
    numbers): linear weights N(0, 1/d_in), zero biases, unit layer norms,
    convs N(0, 0.02^2), token embedding N(0, 0.02^2), text positions
    N(0, 0.01^2), sinusoidal audio positions. Its parameters do not
    require gradients (training turns them on: ``train.py``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Whisper(dims, device='meta', dtype=dtype).to_empty(device=device)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=device,
                            dtype=torch.float32) * std)

    for name, p in model.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        if name == 'encoder.pos_emb':
            p.copy_(torch.from_numpy(sinusoids(*p.shape)))
        elif name == 'decoder.token_emb':
            normal(p, 0.02)
        elif name == 'decoder.pos_emb':
            normal(p, 0.01)
        elif '.conv' in f'.{name}' and leaf == 'weight':
            normal(p, 0.02)
        elif leaf == 'bias':
            p.zero_()
        elif p.ndim == 1:      # layer-norm gains
            p.fill_(1.0)
        else:                  # linear (out, in)
            normal(p, p.shape[1] ** -0.5)
    return model.requires_grad_(False)
