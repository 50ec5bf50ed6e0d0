"""Weights across packages: the JAX parameter pytree -> the port's modules.

stable_ts_tpu keeps (model.py:83-125, 386-395, 938-988):
- linear weights as (d_in, d_out), applied as ``x @ w``: transposed here to
  torch's (d_out, d_in);
- conv weights as (width, in, out) (HIO): transposed to (out, in, width);
- every per-layer leaf stacked along a leading (L, ...) axis: split here
  into one module per block;
- a ``dq`` model's linear weights as ``QuantizedArray`` leaves
  (quantization.py:33-74): ``q`` (L, in, out) int8 and ``scale``
  (L, 1, out) f32, mapped exactly to the port's
  :class:`~.quantization.QuantizedLinear` ``weight`` (out, in) and
  ``scale`` (out,).
"""
import numpy as np
import torch

from .dims import ModelDimensions
from .model import Whisper, resolve_device
from .quantization import quantize_params


def _is_quantized(leaf) -> bool:
    return hasattr(leaf, 'q') and hasattr(leaf, 'scale')


def _linear_tree(prefix: str, tree: dict, layer: int, out: dict) -> None:
    w = tree['w']
    if _is_quantized(w):
        out[f'{prefix}.weight'] = np.asarray(w.q)[layer].T
        out[f'{prefix}.scale'] = np.asarray(w.scale)[layer, 0]
    else:
        out[f'{prefix}.weight'] = np.asarray(w)[layer].T
    if 'b' in tree:
        out[f'{prefix}.bias'] = np.asarray(tree['b'])[layer]


def _block_state(prefix: str, blocks: dict, layer: int, out: dict) -> None:
    for ln in ('attn_ln', 'cross_attn_ln', 'mlp_ln'):
        if ln in blocks:
            out[f'{prefix}.{ln}.weight'] = np.asarray(blocks[ln]['g'])[layer]
            out[f'{prefix}.{ln}.bias'] = np.asarray(blocks[ln]['b'])[layer]
    for attn in ('attn', 'cross_attn'):
        if attn in blocks:
            for proj in ('q', 'k', 'v', 'out'):
                _linear_tree(f'{prefix}.{attn}.{proj}', blocks[attn][proj],
                             layer, out)
    for fc in ('fc1', 'fc2'):
        _linear_tree(f'{prefix}.mlp.{fc}', blocks['mlp'][fc], layer, out)


def jax_state_dict(params: dict, dims: ModelDimensions) -> dict:
    """Numpy state dict of the port's :class:`Whisper` from a JAX pytree."""
    enc, dec = params['encoder'], params['decoder']
    out = {}
    for conv in ('conv1', 'conv2'):
        out[f'encoder.{conv}.weight'] = np.asarray(enc[conv]['w']).transpose(2, 1, 0)
        out[f'encoder.{conv}.bias'] = np.asarray(enc[conv]['b'])
    out['encoder.pos_emb'] = np.asarray(enc['pos_emb'])
    for i in range(dims.n_audio_layer):
        _block_state(f'encoder.blocks.{i}', enc['blocks'], i, out)
    out['encoder.ln_post.weight'] = np.asarray(enc['ln_post']['g'])
    out['encoder.ln_post.bias'] = np.asarray(enc['ln_post']['b'])
    out['decoder.token_emb'] = np.asarray(dec['token_emb'])
    out['decoder.pos_emb'] = np.asarray(dec['pos_emb'])
    for i in range(dims.n_text_layer):
        _block_state(f'decoder.blocks.{i}', dec['blocks'], i, out)
    out['decoder.ln.weight'] = np.asarray(dec['ln']['g'])
    out['decoder.ln.bias'] = np.asarray(dec['ln']['b'])
    return out


@torch.no_grad()
def copy_state(model: torch.nn.Module, state: dict, to_tensor) -> None:
    """Copy ``state`` (name -> array) into ``model``'s parameters and
    buffers, ``to_tensor(value, target)`` making each source tensor. The
    names must be the model's, and every shape its target's."""
    names = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    if set(names) != set(state):
        raise ValueError(f'parameter mismatch: missing '
                         f'{sorted(set(names) - set(state))}, unexpected '
                         f'{sorted(set(state) - set(names))}')
    for name, p in names.items():
        src = to_tensor(state[name], p)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f'{name}: shape {tuple(src.shape)} != {tuple(p.shape)}')
        p.copy_(src)


@torch.no_grad()
def from_jax_params(params: dict, dims: ModelDimensions,
                    device='cuda') -> Whisper:
    """The port's model on ``device`` holding the same weights as a JAX
    pytree whose leaves are numpy arrays (or anything ``np.asarray``
    takes), in the pytree's float dtype (f32 or bf16). A pytree with
    quantized linears gives a model with
    :class:`~.quantization.QuantizedLinear` holding the same int8 values
    and scales. Its parameters do not require gradients."""
    device = resolve_device(device)
    state = jax_state_dict(params, dims)
    dtype = (torch.bfloat16 if state['decoder.token_emb'].dtype.name == 'bfloat16'
             else torch.float32)
    model = Whisper(dims, device='meta', dtype=dtype).to_empty(device=device)
    if any(name.endswith('.scale') for name in state):
        quantize_params(model, empty=True)
    # a writable copy: int8 values exactly, floats through f32
    copy_state(model, state, lambda v, p: torch.from_numpy(np.array(
        v, dtype=np.int8 if p.dtype == torch.int8 else np.float32)))
    return model.requires_grad_(False)
