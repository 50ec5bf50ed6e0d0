"""Cross-attention for one decode step (kernel D's cross entries,
``csrc/decode_attn.cu``).

Replaces stable_ts_tpu/ops/cross_attn.py:_kernel (``cross_attn_decode``),
all its branches: g = 1, one query row per window, and q_per_kv = g > 1,
the g beams or best_of candidates of a window reading that window's K/V
(rows b*g ... b*g + g - 1 read window b); float, int8 or (``bits=4``)
packed int4 K/V. Each query attends keys j < s of the window's precomputed
cross-attention K/V, the largest stream a decode step reads. Both entries
run one kernel: the keys of a head are split in 8 chunks, one block each,
the 8 blocks of a head one thread-block cluster; each block copies its
chunk's K and V head slices into shared memory once, dequantizes in
registers with the per-position scales and applies each row to all query
rows of its window (up to 8 per block), so the stream is read once per
window, not per row. The chunks agree on the global maximum through
distributed shared memory before any weight is rounded, and the first
block sums the chunks' partial outputs in a fixed order (no atomics:
reruns are bit-identical). At most ``self_attn.MAX_KEYS_CROSS`` keys.

As the TPU kernel does for its MXU (cross_attn.py:107,118-120,129), the
query and the softmax weights (times the V scales) are rounded to bf16
before the two products; sums and the softmax stay f32. The twin rounds at
the same places, so the two packages decode the same tokens.

Layout (the port's, row-major so a head's slice of a row is contiguous):
kv (L, B, 2, S, d) with [:, :, 0] = K and [:, :, 1] = V; sc (L, B, 2, S).
Packed int4 is (L, B, 2, S, d / 2) int8 bytes holding dim 2i in the low
nibble and dim 2i + 1 in the high nibble (:func:`pack_int4`); the values
and scales are the TPU's, the nibble order is not (JAX packs dims r and
r + d/2 together, which suits its transposed tiles).
"""
import torch

from .self_attn import _decode_cuda


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] (..., d), d even -> (..., d / 2) bytes, dim 2i
    in the low nibble, dim 2i + 1 in the high nibble."""
    q32 = q.to(torch.int32)
    byte = (q32[..., 0::2] & 0xF) | ((q32[..., 1::2] & 0xF) << 4)   # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., d / 2) bytes -> (..., d) int8."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8          # sign-extend the low nibble
    hi = p32 >> 4                       # arithmetic: the signed high nibble
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], -1).to(torch.int8)


def cross_attn_decode_ref(q, k, v, k_scale, v_scale, s: int, n_head: int,
                          q_per_kv: int = 1) -> torch.Tensor:
    """Plain twin. q: (B*g, d) f32, already scaled by d_head**-0.5; k/v:
    one layer's (B, S, d) K and V (unpacked); k_scale/v_scale: (B, S). Keys
    j < s take part; query row r reads window r // g. Returns (B*g, d)
    f32."""
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
                      q_per_kv: int = 1, bits: int = 8) -> torch.Tensor:
    """One decode step of cross-attention in layer ``layer`` of the stacked
    (L, B, 2, S, d) K/V with (L, B, 2, S) scales, for B * q_per_kv query
    rows. ``bits=4`` states that kv is packed int4, (L, B, 2, S, d / 2);
    any other value, that it holds one value per element. A CPU tensor
    goes to the plain twin, a CUDA tensor to the kernel (the group entry
    when q_per_kv > 1)."""
    packed = _packed(q, kv, bits)
    k, v = kv[layer, :, 0], kv[layer, :, 1]
    ks, vs = sc[layer, :, 0], sc[layer, :, 1]
    if q.device.type == 'cpu':
        if packed:
            k, v = unpack_int4(k), unpack_int4(v)
        return cross_attn_decode_ref(q, k, v, ks, vs, s, n_head, q_per_kv)
    if q.device.type != 'cuda':
        raise ValueError(f'cross_attn_decode: unsupported device {q.device}')
    if q_per_kv > 1:
        return _decode_cuda('cross_attn_decode_group', q, k, v, ks, vs, s,
                            n_head, g=q_per_kv, packed=packed)
    return _decode_cuda('cross_attn_decode', q, k, v, ks, vs, s, n_head,
                        packed=packed)


def cross_attn_decode_indirect(q, kv, sc, bases, layer: int, s: int,
                               n_head: int, bits: int = 8) -> torch.Tensor:
    """:func:`cross_attn_decode` of one query row a window on the card,
    whose kernel reads the buffers' addresses on the device: ``bases`` is a
    (2,) int64 tensor holding the addresses of a K/V buffer and a scale
    buffer laid out as ``kv`` and ``sc``, which give only the layout. A
    captured CUDA graph so reads each group's new cross K/V. A wrapper of
    its own rather than an argument of :func:`cross_attn_decode`, whose
    arguments perfbench's roofline rules (``perfbench/roofline.py``) take
    as they are."""
    packed = _packed(q, kv, bits)
    if q.device.type != 'cuda' or bases.dtype != torch.int64 or bases.shape != (2,):
        raise ValueError('cross_attn_decode_indirect: a CUDA query and two '
                         'int64 addresses')
    return _decode_cuda('cross_attn_decode', q, kv[layer, :, 0], kv[layer, :, 1],
                        sc[layer, :, 0], sc[layer, :, 1], s, n_head, packed=packed,
                        bases=(bases, kv.data_ptr(), sc.data_ptr()))


def _packed(q, kv, bits: int) -> bool:
    """Whether kv is packed int4; the caller states the packing, held
    against the shapes (cross_attn.py:247-255) instead of guessed from
    them."""
    if bits == 4:
        if kv.dtype != torch.int8 or kv.shape[-1] * 2 != q.shape[-1]:
            raise ValueError(f'bits=4 expects packed int8 K/V rows of '
                             f'{q.shape[-1] // 2} bytes, got {kv.dtype} rows '
                             f'of {kv.shape[-1]}')
    elif kv.shape[-1] != q.shape[-1]:
        raise ValueError(f'K/V width {kv.shape[-1]} != query width '
                         f'{q.shape[-1]} (pass bits=4 for packed int4)')
    return bits == 4
