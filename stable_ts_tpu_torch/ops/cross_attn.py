"""Cross-attention for one decode step (kernel D's cross entries,
``csrc/decode_attn.cu``).

Replaces stable_ts_tpu/ops/cross_attn.py:_kernel (``cross_attn_decode``,
its 8-bit or float tiles), both branches: g = 1, one query row per window,
and q_per_kv = g > 1, the g beams or best_of candidates of a window reading
that window's K/V (rows b*g ... b*g + g - 1 read window b). Each query
attends keys j < s of the window's precomputed cross-attention K/V, the
largest stream a decode step reads. The kernels read each K/V row once per
block with wide loads and dequantize in registers with the per-position
scales; the group entry applies each row to all g queries of its window
(up to 8 per block), so the stream is read once per window, not per row.

As the TPU kernel does for its MXU (cross_attn.py:107,118-120,129), the
query and the softmax weights (times the V scales) are rounded to bf16
before the two products; sums and the softmax stay f32. The twin rounds at
the same places, so the two packages decode the same tokens.

Layout (the port's, row-major so a head's slice of a row is contiguous):
kv (L, B, 2, S, d) with [:, :, 0] = K and [:, :, 1] = V; sc (L, B, 2, S).
"""
import torch

from .self_attn import _decode_cuda


def cross_attn_decode_ref(q, k, v, k_scale, v_scale, s: int, n_head: int,
                          q_per_kv: int = 1) -> torch.Tensor:
    """Plain twin. q: (B*g, d) f32, already scaled by d_head**-0.5; k/v:
    one layer's (B, S, d) K and V; k_scale/v_scale: (B, S). Keys j < s
    take part; query row r reads window r // g. Returns (B*g, d) f32."""
    rows, d = q.shape
    b, g, dh = k.shape[0], q_per_kv, d // n_head
    qh = q.float().to(torch.bfloat16).float().reshape(b, g, n_head, dh)
    qh = qh.transpose(1, 2)                                      # (B, H, g, dh)
    kf = k[:, :s].float().reshape(b, s, n_head, dh).permute(0, 2, 3, 1)
    lg = (qh @ kf) * k_scale[:, None, None, :s]                  # (B, H, g, s)
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    w = (p * v_scale[:, None, None, :s]).to(torch.bfloat16).float()
    vf = v[:, :s].float().reshape(b, s, n_head, dh).transpose(1, 2)
    out = (w @ vf) / l                                           # (B, H, g, dh)
    return out.transpose(1, 2).reshape(rows, d)


def cross_attn_decode(q, kv, sc, layer: int, s: int, n_head: int,
                      q_per_kv: int = 1) -> torch.Tensor:
    """One decode step of cross-attention in layer ``layer`` of the stacked
    (L, B, 2, S, d) K/V with (L, B, 2, S) scales, for B * q_per_kv query
    rows. A CPU tensor goes to the plain twin, a CUDA tensor to the kernel
    (the group entry when q_per_kv > 1)."""
    k, v = kv[layer, :, 0], kv[layer, :, 1]
    ks, vs = sc[layer, :, 0], sc[layer, :, 1]
    if q.device.type == 'cpu':
        return cross_attn_decode_ref(q, k, v, ks, vs, s, n_head, q_per_kv)
    if q.device.type != 'cuda':
        raise ValueError(f'cross_attn_decode: unsupported device {q.device}')
    if q_per_kv > 1:
        return _decode_cuda('cross_attn_decode_group', q, k, v, ks, vs, s,
                            n_head, g=q_per_kv)
    return _decode_cuda('cross_attn_decode', q, k, v, ks, vs, s, n_head)
