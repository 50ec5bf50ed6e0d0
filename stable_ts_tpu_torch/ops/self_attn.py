"""Self-attention for one decode step (kernel D's self entry,
``csrc/decode_attn.cu``).

Replaces stable_ts_tpu/ops/self_attn.py:_kernel (``self_attn_decode``, the
non-beam path). The query at position ``pos`` attends keys j <= pos of one
layer's row-major cache (B, C, d): int8 rows with per-position scales (the
decode path's cache), or bf16/f32 rows. The kernel reads each row once
with 16-byte loads and dequantizes in registers; no dequantized copy of the
cache exists. The math is f32 throughout, as in the XLA cache path that
stable_ts_tpu takes off the TPU (model.py:752-780).

Cache layout (the port's): k, v (L, B, C, d); k_scale, v_scale (L, B, C).
"""
import torch

from .. import _build


def self_attn_decode_ref(q, k, v, k_scale, v_scale, pos: int,
                         n_head: int) -> torch.Tensor:
    """Plain twin. q: (B, d) f32, already scaled by d_head**-0.5; k/v:
    one layer's (B, C, d) cache; k_scale/v_scale: (B, C) or None.
    Returns (B, d) f32."""
    b, d = q.shape
    dh = d // n_head
    n = pos + 1
    kf = k[:, :n].float()
    vf = v[:, :n].float()
    qh = q.float().reshape(b, n_head, 1, dh)
    lg = qh @ kf.reshape(b, n, n_head, dh).permute(0, 2, 3, 1)   # (B, H, 1, n)
    if k_scale is not None:
        lg = lg * k_scale[:, None, None, :n]
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, None, None, :n]
    out = (p @ vf.reshape(b, n, n_head, dh).transpose(1, 2)) / l
    return out.reshape(b, d)


def self_attn_decode(q, k, v, k_scale, v_scale, pos: int,
                     n_head: int) -> torch.Tensor:
    """One decode step of self-attention against one layer's cache; the
    current token's row must already be written at ``pos``. A CPU tensor
    goes to the plain twin, a CUDA tensor to the kernel."""
    if q.device.type == 'cpu':
        return self_attn_decode_ref(q, k, v, k_scale, v_scale, pos, n_head)
    if q.device.type != 'cuda':
        raise ValueError(f'self_attn_decode: unsupported device {q.device}')
    return _decode_cuda('self_attn_decode', q, k, v, k_scale, v_scale,
                        pos + 1, n_head)


def _decode_cuda(entry, q, k, v, k_scale, v_scale, n_keys, n_head):
    """Launch one of decode_attn.cu's entries. k/v: (B, S, d) views whose
    rows are contiguous (batch and row strides are passed through);
    scales: (B, S) views with unit stride along S, or None."""
    b, d = q.shape
    dh = d // n_head
    if dh not in (32, 64) or d != n_head * dh:
        raise ValueError(f'decode kernel takes d_head 32 or 64, got d={d} '
                         f'with {n_head} heads')
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise TypeError('decode kernel takes a contiguous f32 query')
    if k.dtype != v.dtype or k.stride() != v.stride() or k.shape != v.shape:
        raise ValueError('decode kernel: k and v must share dtype and layout')
    if k.shape[0] != b or k.shape[2] != d or not 1 <= n_keys <= k.shape[1]:
        raise ValueError(f'decode kernel: cache {tuple(k.shape)} for query '
                         f'{tuple(q.shape)} and {n_keys} keys')
    if n_keys > 8192:
        raise ValueError('decode kernel holds at most 8192 keys')
    es = k.element_size()
    if (k.stride(2) != 1 or k.data_ptr() % 16 or v.data_ptr() % 16
            or (k.stride(0) * es) % 16 or (k.stride(1) * es) % 16):
        raise ValueError('decode kernel needs 16-byte aligned cache rows')
    sc_bs = 0
    if k_scale is not None:
        if (k_scale.dtype != torch.float32 or k_scale.stride(1) != 1
                or k_scale.stride() != v_scale.stride()
                or k_scale.shape[0] != b or k_scale.shape[1] < n_keys):
            raise ValueError('decode kernel: scales must be f32 (B, S) views')
        sc_bs = k_scale.stride(0)
    if not (q.device == k.device == v.device):
        raise ValueError('decode kernel: q and the cache must share a device')
    out = torch.empty((b, d), dtype=torch.float32, device=q.device)
    fn = getattr(_build.lib(), entry)
    _build.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), _build.dtype_code(k.dtype), b, n_head, dh, n_keys,
        k.stride(0), k.stride(1), sc_bs, _build.stream_ptr(q)), entry)
    _build.launches[entry] += 1
    return out
