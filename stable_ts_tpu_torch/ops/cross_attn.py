"""Cross-attention for one decode step (kernel D's cross entries,
``csrc/decode_attn.cu``).

Replaces stable_ts_tpu/ops/cross_attn.py:_kernel (``cross_attn_decode``),
all its branches: g = 1, one query row per window, and q_per_kv = g > 1,
the g beams or best_of candidates of a window reading that window's K/V
(rows b*g ... b*g + g - 1 read window b); float, int8 or (``bits=4``)
packed int4 K/V. Each query attends keys j < s of the window's precomputed
cross-attention K/V, the largest stream a decode step reads: bytes bound
it. Both entries run one kernel: a window's keys are split in 8 chunks,
one block each, the 8 blocks one thread-block cluster. The grid's layout
follows the shape (:func:`head_group`, the heads a block reads, passed to
the kernel): with one query row a window over enough windows, a block
takes a group of heads and streams whole spans of its chunk's K rows,
then V rows, through a ring of shared-memory stages filled by 1D bulk
copies (the wide layout: at 32 windows of large-v3, whole 1280-byte rows,
256 blocks resident at once); at one window, with g > 1 rows a window, or
where a block would stream too few values, a block takes one head and
copies its chunk's K and V head slices at once (the row layout), applying
each row to all query rows of its window (up to 8 per block), so the
stream is read once per window, not per row. Either way each row is
dequantized in registers with the per-position scales, the chunks agree
on the global maximum through distributed shared memory before any
weight is rounded, and the partial outputs are summed over the chunks in
a fixed order (no atomics: reruns are bit-identical). A call is one
launch, counted as ``cross_attn_decode[_int4]`` and, in the wide layout,
also as ``cross_attn_decode[_int4]_wide``. At most
``self_attn.MAX_KEYS_CROSS`` keys.

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
import functools

import torch

from .self_attn import WIDE_SPAN, _decode_cuda

CLUSTER = 8   # key chunks of a head, a block each: decode_attn.cu's cluster
# values a block of the wide layout streams, below which its fixed costs (a
# ring to fill, three cluster barriers, the combine) outweigh the stream:
# on an H100 the row layout is faster at 2 and 3 windows of large-v3 (24,064
# values a block at 2 heads), the wide one from 4 (48,128 at 4 heads)
WIDE_MIN_VALUES = 32768


def head_group(windows: int, g: int, n_head: int, d_head: int, keys: int,
               sms: int) -> int:
    """The heads a block of the cross kernel reads together. The widest
    divisor hg of n_head whose grid, CLUSTER key chunks x n_head / hg head
    groups x ``windows``, still gives each of the card's ``sms`` SMs a
    block, so that a block streams whole spans of hg heads of its window's
    rows. 1 (a head a block: the row layout) where no hg > 1 does, where
    that block's keys x hg heads hold fewer than WIDE_MIN_VALUES values,
    and for g > 1 query rows a window, whose GMAX rows x hg heads of sums
    would not stay in registers. A span holds at most WIDE_SPAN values."""
    if g != 1:
        return 1
    per = -(-keys // CLUSTER)
    for hg in range(n_head, 1, -1):
        if (n_head % hg == 0 and hg * d_head <= WIDE_SPAN
                and CLUSTER * (n_head // hg) * windows >= sms):
            return hg if per * hg * d_head >= WIDE_MIN_VALUES else 1
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _head_group_on(q, kv, s: int, n_head: int) -> int:
    """:func:`head_group` of a g = 1 call on q's card."""
    return head_group(kv.shape[1], 1, n_head, q.shape[1] // n_head, s,
                      _sm_count(q.device))


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
                        packed=packed, hg=_head_group_on(q, kv, s, n_head))


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
                        bases=(bases, kv.data_ptr(), sc.data_ptr()),
                        hg=_head_group_on(q, kv, s, n_head))


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
