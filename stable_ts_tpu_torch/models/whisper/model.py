"""Whisper encoder-decoder in PyTorch (port of stable_ts_tpu/models/whisper/model.py).

Modules hold the weights; the applies are functions over them, named after
their JAX counterparts so a reader finds each one's twin:

- :func:`encoder_apply`: conv stem, then blocks whose self-attention is
  the flash kernel (``ops/flash_attn.py``);
- :func:`decoder_apply`: the teacher-forced pass of the word-timing step,
  with flash cross-attention and the selected heads' raw QK recomputed in
  f32 and stored as bf16 (model.py:377-383, 601-607);
- :func:`decoder_prefill` and :func:`decoder_step`: the incremental
  decoder over an int8 row cache that the step updates IN PLACE (JAX
  threads it through the scan carry instead), with the decode-attention
  kernels (``ops/self_attn.py``, ``ops/cross_attn.py``); the step also
  serves best_of groups and beams (``q_per_kv``, ``anc``) and can return
  the hidden state for the logit epilogue (``ops/logit_epilogue.py``);
- :func:`precompute_cross_kv_t`: per-layer cross-attention K/V once per
  window, in the row-major layout the cross kernel reads.

Numerics follow the JAX package: layer norm in f32 with eps 1e-5, exact-erf
GELU, f32 accumulation, attention scores and logits in f32, and int8
quantization with half-to-even rounding. Linear weights are stored in
torch's (out, in) layout; :mod:`.convert` transposes the JAX (in, out) ones.
"""
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cross_attn import cross_attn_decode
from ...ops.flash_attn import flash_attention
from ...ops.self_attn import self_attn_decode
from .dims import ModelDimensions


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


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions, **factory):
        super().__init__()
        d = dims.n_audio_state
        self.n_head = dims.n_audio_head
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1, **factory)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **factory)
        self.pos_emb = nn.Parameter(torch.empty(dims.n_audio_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_audio_head, False, **factory)
            for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d, **factory)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions, **factory):
        super().__init__()
        d = dims.n_text_state
        self.n_head = dims.n_text_head
        self.token_emb = nn.Parameter(torch.empty(dims.n_vocab, d, **factory))
        self.pos_emb = nn.Parameter(torch.empty(dims.n_text_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_text_head, True, **factory)
            for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d, **factory)
        self._emb_f32 = None  # (token_emb version, f32 copy)

    def vocab_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding projection x @ token_emb^T with f32 logits. A bf16
        model multiplies by an exact f32 copy of the embedding (made once per
        weight version), which equals bf16 products summed in f32 — what the
        JAX package's ``preferred_element_type=float32`` computes."""
        w = self.token_emb
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
    scale = (x.shape[-1] // n_head) ** -0.5
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
                  capture_index: Optional[np.ndarray] = None):
    """Teacher-forced decoder pass.

    tokens (B, T) int64; xa (B, S, d). Returns (logits (B, T, V) f32,
    cross_qk (L, B, slots, T, S) bf16 or None). ``capture_index``
    (L, slots) picks the heads whose raw QK is captured per layer (see
    timing.build_head_capture_table; padding slots repeat head 0); None
    captures every head. The captured QK is recomputed from the selected
    heads only, q and k each scaled by d_head**-0.25, in f32."""
    b, n_tok = tokens.shape
    n_head = decoder.n_head
    d = decoder.token_emb.shape[1]
    dh = d // n_head
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
            heads = torch.tensor(range(n_head) if capture_index is None
                                 else np.asarray(capture_index)[layer],
                                 dtype=torch.long, device=x.device)
            qh = q.reshape(b, n_tok, n_head, dh).transpose(1, 2)[:, heads]
            kh = k.reshape(b, -1, n_head, dh).transpose(1, 2)[:, heads]
            scale = dh ** -0.25
            qk = (qh * scale).float() @ (kh * scale).float().transpose(-1, -2)
            qks.append(qk.to(torch.bfloat16))
    x = decoder.ln(x)
    logits = decoder.vocab_logits(x)
    return logits, (torch.stack(qks) if capture_qk else None)


def quantize_rows(t: torch.Tensor):
    """Per-row symmetric int8 over the last axis: (..., d) -> int8 (..., d)
    and f32 scales (...,). Half-to-even rounding, as jnp.round."""
    t32 = t.float()
    amax = t32.abs().amax(dim=-1, keepdim=True)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(t32 / sc), -127, 127).to(torch.int8)
    return q, sc[..., 0]


def decoder_prefill(decoder: TextDecoder, tokens: torch.Tensor,
                    xa: torch.Tensor, n_text_ctx: int):
    """Teacher-forced pass over the initial tokens that also fills the int8
    row cache for positions [0, T). Returns (logits (B, T, V) f32, cache
    {'k', 'v': int8 (L, B, n_text_ctx, d); 'ks', 'vs': f32 (L, B, n_text_ctx)});
    unwritten rows are zero with scale 1 (model.py:839-850)."""
    b, n_tok = tokens.shape
    n_head = decoder.n_head
    d = decoder.token_emb.shape[1]
    n_layers = len(decoder.blocks)
    x = _embed(decoder, tokens)
    dev = x.device
    cache = {
        'k': torch.zeros((n_layers, b, n_text_ctx, d), dtype=torch.int8, device=dev),
        'v': torch.zeros((n_layers, b, n_text_ctx, d), dtype=torch.int8, device=dev),
        'ks': torch.ones((n_layers, b, n_text_ctx), dtype=torch.float32, device=dev),
        'vs': torch.ones((n_layers, b, n_text_ctx), dtype=torch.float32, device=dev),
    }
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
        for name, t in (('k', k), ('v', v)):
            qt, sc = quantize_rows(t)
            cache[name][layer, :, :n_tok] = qt
            cache[name + 's'][layer, :, :n_tok] = sc
    x = decoder.ln(x)
    return decoder.vocab_logits(x), cache


def fuse_self_qkv(decoder: TextDecoder):
    """Per-layer (w (3d, d), b (3d,)) of the self-attention q/k/v
    projections concatenated (model.py:459): one product per layer per
    token instead of three. k has no bias; its slot is zeros."""
    fused = []
    for blk in decoder.blocks:
        a = blk.attn
        w = torch.cat([a.q.weight, a.k.weight, a.v.weight], dim=0)
        bias = torch.cat([a.q.bias, torch.zeros_like(a.q.bias), a.v.bias])
        fused.append((w, bias))
    return fused


def precompute_cross_kv_t(decoder: TextDecoder, xa: torch.Tensor,
                          quantize: bool = False):
    """Cross-attention K/V of every layer, once per window, in the layout
    the cross kernel reads (model.py:487-547, re-laid out row-major):
    {'kv': (L, B, 2, S, d) int8 or xa's dtype, 'sc': (L, B, 2, S) f32
    per-position scales (ones when float), 's': S}."""
    b, s, d = xa.shape
    n_layers = len(decoder.blocks)
    dtype = torch.int8 if quantize else xa.dtype
    kv = torch.empty((n_layers, b, 2, s, d), dtype=dtype, device=xa.device)
    sc = torch.ones((n_layers, b, 2, s), dtype=torch.float32, device=xa.device)
    for layer, blk in enumerate(decoder.blocks):
        ca = blk.cross_attn
        for slot, t in enumerate((ca.k(xa), ca.v(xa))):
            if quantize:
                kv[layer, :, slot], sc[layer, :, slot] = quantize_rows(t)
            else:
                kv[layer, :, slot] = t
    return {'kv': kv, 'sc': sc, 's': s}


def decoder_step(decoder: TextDecoder, tokens: torch.Tensor, pos: int,
                 cross_kv: dict, cache: dict, fused_qkv: List,
                 q_per_kv: int = 1, anc: Optional[torch.Tensor] = None,
                 return_hidden: bool = False) -> torch.Tensor:
    """One decode step at position ``pos``. tokens (B, 1). Writes this
    position's int8 K/V rows into ``cache`` in place, then attends keys
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
    d = decoder.token_emb.shape[1]
    q_scale = (d // n_head) ** -0.5
    x = _embed(decoder, tokens, offset=pos)
    for layer, blk in enumerate(decoder.blocks):
        w, bias = fused_qkv[layer]
        qkv = F.linear(blk.attn_ln(x), w, bias)
        q_proj, new_k, new_v = qkv[:, 0].split(d, dim=-1)
        for name, t in (('k', new_k), ('v', new_v)):
            qt, sc = quantize_rows(t)
            cache[name][layer, :, pos] = qt
            cache[name + 's'][layer, :, pos] = sc
        ctx = self_attn_decode(q_proj.float() * q_scale, cache['k'][layer],
                               cache['v'][layer], cache['ks'][layer],
                               cache['vs'][layer], pos, n_head, anc=anc,
                               q_per_kv=q_per_kv)
        x = x + blk.attn.out(ctx[:, None].to(x.dtype))
        ca = blk.cross_attn
        q = ca.q(blk.cross_attn_ln(x))[:, 0].float() * q_scale
        ctx = cross_attn_decode(q, cross_kv['kv'], cross_kv['sc'], layer,
                                cross_kv['s'], n_head, q_per_kv=q_per_kv)
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
                dtype: torch.dtype = torch.float32, device='cpu') -> Whisper:
    """A random-weight model drawn from a ``torch.Generator`` on ``device``
    (the same distributions as the JAX package's init_params, not the same
    numbers): linear weights N(0, 1/d_in), zero biases, unit layer norms,
    convs N(0, 0.02^2), token embedding N(0, 0.02^2), text positions
    N(0, 0.01^2), sinusoidal audio positions."""
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
