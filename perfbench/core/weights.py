"""Random Whisper weights drawn from the seed, in OpenAI's state-dict layout.

One ``torch.randn`` call on the device fills a flat buffer in the served
dtype; each weight is a view of it scaled in place to its standard
deviation, with the distributions of the port's ``init_params``: linear
weights N(0, 1/d_in), convolutions N(0, 0.02^2), the token embedding
N(0, 0.02^2), the text positions N(0, 0.01^2), the sinusoidal audio
positions, zero biases and unit layer-norm gains. The same seed gives the
same bytes, so the reference rebuilds the very weights the program served
without keeping a second copy on the card while the program runs.
"""
from typing import Dict, List, Tuple

import numpy as np
import torch


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0):
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def layout(dims: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every tensor; kind is 'normal', 'zeros',
    'ones' or 'sinusoids'."""
    out = []
    d_a, d_t, n_mels = dims['n_audio_state'], dims['n_text_state'], dims['n_mels']

    def linear(prefix, d_out, d_in, bias=True):
        out.append((f'{prefix}.weight', (d_out, d_in), 'normal', d_in ** -0.5))
        if bias:
            out.append((f'{prefix}.bias', (d_out,), 'zeros', 0.0))

    def norm(prefix, d):
        out.append((f'{prefix}.weight', (d,), 'ones', 0.0))
        out.append((f'{prefix}.bias', (d,), 'zeros', 0.0))

    def block(prefix, d, cross):
        attns = ['attn', 'cross_attn'] if cross else ['attn']
        for a in attns:
            linear(f'{prefix}.{a}.query', d, d)
            linear(f'{prefix}.{a}.key', d, d, bias=False)
            linear(f'{prefix}.{a}.value', d, d)
            linear(f'{prefix}.{a}.out', d, d)
            norm(f'{prefix}.{a}_ln', d)
        linear(f'{prefix}.mlp.0', 4 * d, d)
        linear(f'{prefix}.mlp.2', d, 4 * d)
        norm(f'{prefix}.mlp_ln', d)

    out.append(('encoder.conv1.weight', (d_a, n_mels, 3), 'normal', 0.02))
    out.append(('encoder.conv1.bias', (d_a,), 'zeros', 0.0))
    out.append(('encoder.conv2.weight', (d_a, d_a, 3), 'normal', 0.02))
    out.append(('encoder.conv2.bias', (d_a,), 'zeros', 0.0))
    out.append(('encoder.positional_embedding', (dims['n_audio_ctx'], d_a),
                'sinusoids', 0.0))
    for i in range(dims['n_audio_layer']):
        block(f'encoder.blocks.{i}', d_a, False)
    norm('encoder.ln_post', d_a)
    out.append(('decoder.token_embedding.weight', (dims['n_vocab'], d_t),
                'normal', 0.02))
    out.append(('decoder.positional_embedding', (dims['n_text_ctx'], d_t),
                'normal', 0.01))
    for i in range(dims['n_text_layer']):
        block(f'decoder.blocks.{i}', d_t, True)
    norm('decoder.ln', d_t)
    return out


@torch.no_grad()
def state_dict(dims: dict, seed: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """The OpenAI-layout state dict of ``dims`` drawn from ``seed`` on
    ``device`` in ``dtype``."""
    items = layout(dims)
    n_random = sum(int(np.prod(s)) for _, s, k, _ in items if k == 'normal')
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n_random, generator=gen, dtype=dtype, device=device)
    sd, at = {}, 0
    for name, shape, kind, std in items:
        if kind == 'normal':
            n = int(np.prod(shape))
            sd[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif kind == 'zeros':
            sd[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == 'ones':
            sd[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            sd[name] = torch.from_numpy(sinusoids(*shape)).to(device, dtype)
    return sd
