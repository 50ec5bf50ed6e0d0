"""Checkpoint loading: OpenAI Whisper .pt, HF and MLX directories -> the
port's :class:`~.model.Whisper` (port of stable_ts_tpu/models/whisper/load.py).

The JAX package converts every format into its stacked-layer pytree; here
the target is a torch module whose Linear (out, in) and Conv1d (out, in,
width) layouts are already the checkpoints', so nothing is transposed but
MLX's conv weights (stored (out, width, in)). What changes is the names:
OpenAI's ``attn.query`` is the port's ``attn.q``, ``mlp.0`` its
``mlp.fc1``, ``token_embedding.weight`` its ``token_emb`` (see
:func:`openai_key_to_port`), and HF's names go through OpenAI's first
(:func:`hf_key_to_openai`). The module is built on ``'meta'`` and
materialized on the target device; every name and shape must match.

Safetensors files are read by :func:`read_safetensors`, this module's own
reader of the format (an 8-byte little-endian header length, a JSON header
of names, dtypes, shapes and byte ranges, then the raw bytes), so the
package needs no ``safetensors`` install.

``dtype=None`` gives an f32 model, whatever the checkpoint holds (bf16 and
f16 widen exactly), as the JAX package's loader does; ``dtype=
torch.bfloat16`` gives a bf16 model (f32 weights round to nearest even).
"""
import json
import os
import struct
import zipfile
from dataclasses import asdict, fields
from typing import Dict, Tuple

import numpy as np
import torch

from .convert import copy_state
from .dims import ModelDimensions
from .model import Whisper, resolve_device, sinusoids

# safetensors dtype tag -> torch dtype: the float types checkpoints hold
_SAFETENSORS_DTYPES = {'F64': torch.float64, 'F32': torch.float32,
                       'F16': torch.float16, 'BF16': torch.bfloat16}
_MODEL_DTYPES = (torch.float32, torch.bfloat16)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors in the file's
    dtypes (views of one buffer holding the file's data). The header's
    ``__metadata__`` entry is skipped."""
    with open(path, 'rb') as f:
        (header_len,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - header_len)
        if f.readinto(data) != len(data):
            raise ValueError(f'{path}: truncated safetensors data')
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dtype = _SAFETENSORS_DTYPES.get(info['dtype'])
        if dtype is None:
            raise ValueError(f'{path}: {name} has unsupported dtype {info["dtype"]}')
        begin, end = info['data_offsets']
        shape = tuple(info['shape'])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * itemsize or end > len(data):
            raise ValueError(f'{path}: {name} byte range {begin}-{end} does not '
                             f'hold {shape} of {info["dtype"]}')
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(shape)
    return out


def _read_safetensors_dir(model_dir: str) -> Dict[str, torch.Tensor]:
    sd = {}
    for fname in sorted(os.listdir(model_dir)):
        if fname.endswith('.safetensors'):
            sd.update(read_safetensors(os.path.join(model_dir, fname)))
    if not sd:
        raise FileNotFoundError(f'no .safetensors files in {model_dir}')
    return sd


# OpenAI state-dict name fragments -> the port's module names
_OPENAI_TO_PORT = [
    ('attn.query.', 'attn.q.'),      # and cross_attn.query.
    ('attn.key.', 'attn.k.'),
    ('attn.value.', 'attn.v.'),
    ('.mlp.0.', '.mlp.fc1.'),
    ('.mlp.2.', '.mlp.fc2.'),
    ('encoder.positional_embedding', 'encoder.pos_emb'),
    ('decoder.token_embedding.weight', 'decoder.token_emb'),
    ('decoder.positional_embedding', 'decoder.pos_emb'),
]


def openai_key_to_port(key: str) -> str:
    for old, new in _OPENAI_TO_PORT:
        key = key.replace(old, new)
    return key


def port_key_to_openai(key: str) -> str:
    for old, new in reversed(_OPENAI_TO_PORT):
        key = key.replace(new, old)
    return key


def _model_dtype(dtype) -> torch.dtype:
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in _MODEL_DTYPES:
        raise ValueError(f'dtype must be None, torch.float32 or torch.bfloat16, '
                         f'got {dtype}')
    return dtype


@torch.no_grad()
def convert_openai_state_dict(sd: Dict[str, torch.Tensor], dims: ModelDimensions,
                              dtype=None, device='cuda') -> Whisper:
    """OpenAI Whisper state dict -> the port's model on ``device`` in
    ``dtype`` (None: f32). A missing ``encoder.positional_embedding`` is
    filled with the sinusoids it always holds. Every other name and every
    shape must match the model's; its parameters do not require
    gradients."""
    device = resolve_device(device)
    state = {openai_key_to_port(k): v for k, v in sd.items()}
    state.setdefault('encoder.pos_emb', torch.from_numpy(
        sinusoids(dims.n_audio_ctx, dims.n_audio_state)))
    model = Whisper(dims, device='meta', dtype=_model_dtype(dtype))
    model = model.to_empty(device=device)
    copy_state(model, state, lambda v, p: torch.as_tensor(v))
    return model.requires_grad_(False)


# HF transformers key -> OpenAI key fragments (cf. reference hf_whisper.py:30-51).
_HF_TO_OPENAI = [
    ('model.', ''),
    ('layers', 'blocks'),
    ('fc1', 'mlp.0'),
    ('fc2', 'mlp.2'),
    ('final_layer_norm', 'mlp_ln'),
    ('q_proj', 'query'),
    ('k_proj', 'key'),
    ('v_proj', 'value'),
    ('out_proj', 'out'),
    ('self_attn_layer_norm', 'attn_ln'),
    ('self_attn', 'attn'),
    ('encoder_attn_layer_norm', 'cross_attn_ln'),
    ('encoder_attn', 'cross_attn'),
    ('embed_positions.weight', 'positional_embedding'),
    ('embed_tokens', 'token_embedding'),
    ('encoder.layer_norm', 'encoder.ln_post'),
    ('decoder.layer_norm', 'decoder.ln'),
]


def hf_key_to_openai(key: str) -> str:
    for old, new in _HF_TO_OPENAI:
        key = key.replace(old, new)
    return key


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], dims: ModelDimensions,
                          dtype=None, device='cuda') -> Whisper:
    """HF Whisper state dict -> the port's model; ``proj_out.weight`` (tied
    to the token embedding) is dropped."""
    remapped = {hf_key_to_openai(k): v for k, v in sd.items()
                if k != 'proj_out.weight'}
    return convert_openai_state_dict(remapped, dims, dtype=dtype, device=device)


def load_openai_checkpoint(path: str, dtype=None,
                           device='cuda') -> Tuple[ModelDimensions, Whisper]:
    """An OpenAI .pt checkpoint -> (dims, model on ``device``). The file is
    memory-mapped where torch's zip format allows it, and loaded with
    ``weights_only=True`` (a checkpoint holds a dict of ints and a state
    dict), so each tensor is copied once, from the mapped file to the
    device."""
    device = resolve_device(device)
    checkpoint = torch.load(path, map_location='cpu', weights_only=True,
                            mmap=zipfile.is_zipfile(path))
    dims = ModelDimensions(**checkpoint['dims'])
    return dims, convert_openai_state_dict(checkpoint['model_state_dict'], dims,
                                           dtype=dtype, device=device)


def _read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, 'config.json')) as f:
        return json.load(f)


def load_hf_checkpoint(model_dir: str, dtype=None,
                       device='cuda') -> Tuple[ModelDimensions, Whisper]:
    """An HF Whisper directory (config.json and its ``*.safetensors`` files,
    read in sorted order) -> (dims, model on ``device``)."""
    device = resolve_device(device)
    cfg = _read_config(model_dir)
    dims = ModelDimensions(
        n_mels=cfg['num_mel_bins'],
        n_audio_ctx=cfg['max_source_positions'],
        n_audio_state=cfg['d_model'],
        n_audio_head=cfg['encoder_attention_heads'],
        n_audio_layer=cfg['encoder_layers'],
        n_vocab=cfg['vocab_size'],
        n_text_ctx=cfg['max_target_positions'],
        n_text_state=cfg['d_model'],
        n_text_head=cfg['decoder_attention_heads'],
        n_text_layer=cfg['decoder_layers'],
    )
    return dims, convert_hf_state_dict(_read_safetensors_dir(model_dir), dims,
                                       dtype=dtype, device=device)


def load_mlx_checkpoint(model_dir: str, dtype=None,
                        device='cuda') -> Tuple[ModelDimensions, Whisper]:
    """An MLX-community Whisper directory -> (dims, model on ``device``).

    The mlx-community layout keeps OpenAI's state-dict names and a
    config.json holding the ``ModelDimensions`` fields; only the Conv1d
    weights differ: MLX stores (out, width, in), torch (out, in, width).
    Quantized MLX checkpoints raise ``NotImplementedError``."""
    device = resolve_device(device)
    cfg = _read_config(model_dir)
    if cfg.get('quantization'):
        raise NotImplementedError(
            'quantized MLX checkpoints are not supported; convert from the '
            'float weights (dq=True re-quantizes on the device at load time)')
    names = {f.name for f in fields(ModelDimensions)}
    dims = ModelDimensions(**{k: v for k, v in cfg.items() if k in names})
    sd = _read_safetensors_dir(model_dir)
    for key in list(sd):
        if 'conv' in key and sd[key].ndim == 3:
            sd[key] = sd[key].permute(0, 2, 1)
    return dims, convert_openai_state_dict(sd, dims, dtype=dtype, device=device)


def is_mlx_checkpoint_dir(model_dir: str) -> bool:
    """MLX config.json carries ModelDimensions fields ('n_mels'); HF uses
    'num_mel_bins'."""
    if not os.path.isfile(os.path.join(model_dir, 'config.json')):
        return False
    try:
        return 'n_mels' in _read_config(model_dir)
    except (ValueError, OSError):
        return False


@torch.no_grad()
def save_openai_checkpoint(path: str, dims: ModelDimensions, model: Whisper) -> None:
    """Write ``model``'s weights in the OpenAI .pt layout, in their dtype
    (``{'dims': ..., 'model_state_dict': ...}``, OpenAI's names). A ``dq``
    model's int8 linears have no such layout and raise ``ValueError``."""
    if any(b.dtype == torch.int8 for b in model.buffers()):
        raise ValueError('a dq model (int8 linears) cannot be written in the '
                         'OpenAI layout; save the float model')
    sd = {port_key_to_openai(name): p.detach().cpu().contiguous()
          for name, p in model.named_parameters()}
    torch.save({'dims': asdict(dims), 'model_state_dict': sd}, path)
