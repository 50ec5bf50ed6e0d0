"""Cross-attention for one decode step (kernel D's cross entry,
``csrc/decode_attn.cu``).

Replaces stable_ts_tpu/ops/cross_attn.py:_kernel (``cross_attn_decode``,
its g = 1 branch, int8 or float tiles). The query attends keys j < s of the
window's precomputed cross-attention K/V, the largest stream a decode step
reads. The kernel reads each K/V row once with 16-byte loads and
dequantizes in registers with the per-position scales.

As the TPU kernel does for its MXU (cross_attn.py:107,129), the query and
the softmax weights (times the V scales) are rounded to bf16 before the two
products; sums and the softmax stay f32. The twin rounds at the same
places, so the two packages decode the same tokens.

Layout (the port's, row-major so a head's slice of a row is contiguous):
kv (L, B, 2, S, d) with [:, :, 0] = K and [:, :, 1] = V; sc (L, B, 2, S).
"""
import torch

from .self_attn import _decode_cuda


def cross_attn_decode_ref(q, k, v, k_scale, v_scale, s: int,
                          n_head: int) -> torch.Tensor:
    """Plain twin. q: (B, d) f32, already scaled by d_head**-0.5; k/v:
    one layer's (B, S, d) K and V; k_scale/v_scale: (B, S). Keys j < s
    take part. Returns (B, d) f32."""
    b, d = q.shape
    dh = d // n_head
    qh = q.float().to(torch.bfloat16).float().reshape(b, n_head, 1, dh)
    kf = k[:, :s].float().reshape(b, s, n_head, dh).permute(0, 2, 3, 1)
    lg = (qh @ kf) * k_scale[:, None, None, :s]                  # (B, H, 1, s)
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    w = (p * v_scale[:, None, None, :s]).to(torch.bfloat16).float()
    vf = v[:, :s].float().reshape(b, s, n_head, dh).transpose(1, 2)
    return ((w @ vf) / l).reshape(b, d)


def cross_attn_decode(q, kv, sc, layer: int, s: int,
                      n_head: int) -> torch.Tensor:
    """One decode step of cross-attention in layer ``layer`` of the stacked
    (L, B, 2, S, d) K/V with (L, B, 2, S) scales. A CPU tensor goes to the
    plain twin, a CUDA tensor to the kernel."""
    k, v = kv[layer, :, 0], kv[layer, :, 1]
    ks, vs = sc[layer, :, 0], sc[layer, :, 1]
    if q.device.type == 'cpu':
        return cross_attn_decode_ref(q, k, v, ks, vs, s, n_head)
    if q.device.type != 'cuda':
        raise ValueError(f'cross_attn_decode: unsupported device {q.device}')
    return _decode_cuda('cross_attn_decode', q, k, v, ks, vs, s, n_head)
