"""The streamed vocab projection of the beam and sampled decode steps
(kernel V, ``csrc/vocab_proj.cu``).

Replaces stable_ts_tpu/ops/vocab_proj.py:_kernel (``vocab_logits_kernel``):
the tied-embedding logits ``x @ emb^T`` of a decode step, x cast to the
embedding's dtype, products summed in f32, f32 logits. The kernel reads
the (V, d) table from device memory once, as it is stored, for any M up to
``MAX_ROWS``; no transposed or f32 copy of it is made. A bf16 table goes to
the tensor-core kernel (wgmma tiles fed by TMA), an f32 one to the
CUDA-core kernel: the dtype selects, and neither falls back to the other.
:meth:`~..models.whisper.model.TextDecoder.vocab_logits` sends it the
shapes stable_ts_tpu sends its kernel (model.py:150-153): 2-D x of at most
``MAX_ROWS`` rows, a vocabulary of at least ``MIN_VOCAB`` rows.
"""
import torch

from .. import _build

MAX_ROWS = 256
MIN_VOCAB = 2048


def vocab_proj_ref(x, emb) -> torch.Tensor:
    """Plain twin: (M, d) x (V, d) -> (M, V) f32."""
    return x.to(emb.dtype).float() @ emb.float().t()


def vocab_proj(x, emb) -> torch.Tensor:
    """(M, V) f32 logits of x (M, d) against emb (V, d), bf16 or f32. A CPU
    tensor goes to the plain twin, a CUDA tensor to the kernel."""
    if x.device.type == 'cpu':
        return vocab_proj_ref(x, emb)
    if x.device.type != 'cuda':
        raise ValueError(f'vocab_proj: unsupported device {x.device}')
    if x.dim() != 2 or emb.dim() != 2 or x.shape[1] != emb.shape[1]:
        raise ValueError(f'vocab_proj: x {tuple(x.shape)} against emb '
                         f'{tuple(emb.shape)}; x must be 2-D (M, d)')
    m, d = x.shape
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f'vocab_proj takes 1 to {MAX_ROWS} rows, got {m}')
    v = emb.shape[0]
    if emb.dtype not in (torch.bfloat16, torch.float32) or not emb.is_contiguous():
        raise TypeError('vocab_proj: emb must be contiguous bf16 or f32')
    if (d * emb.element_size()) % 16 or emb.data_ptr() % 16:
        raise ValueError(f'vocab_proj: emb rows of {d} values are not 16-byte '
                         'multiples')
    if x.device != emb.device:
        raise ValueError('vocab_proj: operands must share a device')
    x = x.to(emb.dtype).contiguous()
    if x.data_ptr() % 16:   # TMA reads x from a 16-byte aligned base
        x = x.clone()
    out = torch.empty((m, v), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().vocab_proj(
        x.data_ptr(), emb.data_ptr(), out.data_ptr(), _build.dtype_code(emb.dtype),
        m, d, v, _build.stream_ptr(x)), 'vocab_proj')
    _build.launches['vocab_proj'] += 1
    return out
