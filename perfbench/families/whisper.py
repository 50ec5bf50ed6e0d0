"""Whisper: the port's ``WhisperTorch`` on random weights drawn from the
seed in OpenAI's layout (``core/weights.py``) and loaded through the port's
``convert_openai_state_dict``, with the public head mask and the synthetic
rank table; judged by the f32 reference (``reference/``), whose control
is the same reference with float8 e4m3 weights and int4 keys and values.
"""
import base64
import gzip
import time

import numpy as np
import torch

from perfbench.core import weights
from perfbench.core.engine import _sync
from perfbench.core.ranks import rank_table
from perfbench.reference.judge import Judge
from stable_ts_tpu_torch import batched
from stable_ts_tpu_torch.loaders import WhisperTorch
from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions
from stable_ts_tpu_torch.models.whisper.load import convert_openai_state_dict

# the CPU tests' sizes: the published context lengths and vocabulary,
# two layers of two 32-wide heads, and a head mask of three heads
TINY = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_vocab=51866, n_text_ctx=448, n_text_state=64,
            n_text_head=2, n_text_layer=2)
TINY_HEADS = np.array([[0, 1], [1, 1]], bool)

# each entry of ``dims`` and the source's key that publishes it
PUBLISHED = dict(n_audio_ctx='max_source_positions', n_audio_state='d_model',
                 n_audio_head='encoder_attention_heads',
                 n_audio_layer='encoder_layers', n_vocab='vocab_size',
                 n_text_ctx='max_target_positions', n_text_state='d_model',
                 n_text_head='decoder_attention_heads',
                 n_mels='num_mel_bins', n_text_layer='decoder_layers')


def alignment_heads(blob: str, dims: dict):
    """(layer, head) pairs of a public base85 gzip head mask."""
    mask = np.frombuffer(gzip.decompress(base64.b85decode(blob)), dtype=bool)
    mask = mask.reshape(dims['n_text_layer'], dims['n_text_head'])
    return [(int(l), int(h)) for l, h in np.argwhere(mask)]


def build(cfg: dict, seed: int, dtype, device):
    dims = cfg['dims']
    heads = alignment_heads(cfg['alignment_heads'], dims)
    sd = weights.state_dict(dims, seed, dtype, device)
    _sync(torch, device)
    t_drawn = time.perf_counter()
    params = convert_openai_state_dict(sd, ModelDimensions(**dims), dtype=dtype,
                                       device=device)
    del sd
    _sync(torch, device)
    t_converted = time.perf_counter()
    model = WhisperTorch(ModelDimensions(**dims), params, device=device,
                         name=cfg['name'], ranks=rank_table(),
                         alignment_heads=heads)
    return model, [('drawn', t_drawn), ('converted', t_converted)]


def judge(cfg: dict, seed: int, dtype, device, control: bool = False) -> Judge:
    dims = cfg['dims']
    low = dict(weight_format='fp8', kv_bits=4) if control else {}
    return Judge(weights.state_dict(dims, seed, dtype, device), dims, rank_table(),
                 device, **low)


def host_phases() -> dict:
    return batched.HOST_PHASES


def tiny(cfg: dict) -> None:
    cfg['dims'] = dict(TINY)
    cfg['alignment_heads'] = base64.b85encode(
        gzip.compress(TINY_HEADS.tobytes())).decode()


def check_config(cfg: dict) -> None:
    """Every size the port is given under ``dims`` is the source's own,
    the head mask fits the decoder, and nothing is cut."""
    dims = cfg['dims']
    if set(dims) != set(PUBLISHED):
        raise ValueError(f"{cfg['name']}: dims {sorted(dims)} are not Whisper's "
                         f'{sorted(PUBLISHED)}')
    for key, source_key in PUBLISHED.items():
        if dims[key] != cfg[source_key]:
            raise ValueError(f"{cfg['name']}: dims {key} {dims[key]} is not the "
                             f'source\'s {source_key} {cfg[source_key]}')
    if cfg['reduced']:
        raise ValueError(f"{cfg['name']}: a Whisper configuration runs whole, "
                         f"reduced {cfg['reduced']}")
    if not alignment_heads(cfg['alignment_heads'], dims):
        raise ValueError(f"{cfg['name']}: the head mask holds no head")
