"""Non-causal flash attention forward (kernel F, ``csrc/flash_attn.cu``).

Replaces the TPU's Pallas flash attention at both of its call sites in
stable_ts_tpu/models/whisper/model.py: the encoder's self-attention
(``_flash_self_attention``) and the teacher-forced timing pass's
cross-attention (``_flash_cross_attention``). The (T, S) scores never reach
device memory; keys beyond S are masked inside the kernel instead of by the
TPU's segment-id padding. See the kernel source for what bounds it and how
the design answers.

Inputs are (B, T, n_head * d_head) projections (views with a contiguous
last axis are fine: the kernel takes batch and row strides), so no head
split or merge copies exist.
"""
import torch

from .. import _build


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_head: int, scale: float) -> torch.Tensor:
    """Plain twin: softmax(q k^T * scale) v per head, scores in f32.
    q: (B, T, d); k/v: (B, S, d) -> (B, T, d) in q's dtype."""
    b, t, d = q.shape
    s = k.shape[1]
    dh = d // n_head
    qh = q.reshape(b, t, n_head, dh).transpose(1, 2).float()
    kh = k.reshape(b, s, n_head, dh).transpose(1, 2).float()
    vh = v.reshape(b, s, n_head, dh).transpose(1, 2).float()
    w = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
    out = (w @ vh).transpose(1, 2).reshape(b, t, d)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int, scale: float) -> torch.Tensor:
    """Flash attention forward. A CPU tensor goes to the plain twin, a CUDA
    tensor to the kernel."""
    if q.device.type == 'cpu':
        return flash_attention_ref(q, k, v, n_head, scale)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention: unsupported device {q.device}')
    return _flash_cuda(q, k, v, n_head, scale)


def _flash_cuda(q, k, v, n_head, scale):
    b, t, d = q.shape
    s = k.shape[1]
    dh = d // n_head
    if dh not in (32, 64) or d != n_head * dh:
        raise ValueError(f'flash kernel takes d_head 32 or 64, got d={d} '
                         f'with {n_head} heads')
    if k.shape != (b, s, d) or v.shape != (b, s, d):
        raise ValueError(f'flash shapes: q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32,
                                                               torch.bfloat16):
        raise TypeError(f'flash kernel takes f32 or bf16 q/k/v of one dtype, '
                        f'got {q.dtype}, {k.dtype}, {v.dtype}')
    if not (q.device == k.device == v.device):
        raise ValueError('flash kernel: q, k and v must share a device')
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                st * x.element_size() % 16 for st in x.stride()[:2]):
            raise ValueError(f'flash kernel: {name} needs a contiguous last '
                             f'axis and 16-byte aligned rows')
    out = torch.empty((b, t, d), dtype=q.dtype, device=q.device)
    lib = _build.lib()
    _build.check(lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.dtype_code(q.dtype), b, n_head, t, s, dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        float(scale), _build.stream_ptr(q)), 'flash_attn_fwd')
    _build.launches['flash_attn'] += 1
    return out
