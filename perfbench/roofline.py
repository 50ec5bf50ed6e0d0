"""Each ``ops/`` kernel wrapper's bytes and operations, from the shapes it
was called with, and the peaks they are held against.

Every input byte is counted once and every output byte once, whatever a
kernel reads again; where only part of an input is needed (the keys a
decode step attends to), only that part. Operations count the
multiply-adds of the products as two. The bound of a call is
max(bytes / HBM_BYTES_PER_S, operations / the peak of its arithmetic).
Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W.

A rule reads shapes, dtypes and host values only: it launches nothing, so
a rule run while a CUDA graph captures adds no kernel to the graph. Where
the program passes a position on the device, the harness hands the rule
the host position of the step instead (``core/trace.py``).
"""
import re

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12        # tensor cores, bf16 in, f32 accumulate
PEAK_F32 = 67e12          # CUDA cores


def _peak(dtype) -> float:
    return PEAK_BF16 if dtype in (torch.bfloat16, torch.float16) else PEAK_F32


def _b(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def flash_attention(q, k, v, n_head, scale):
    b, t, d = q.shape
    s = k.shape[1]
    return (_b(q) + _b(k) + _b(v) + _b(q), 4 * b * t * s * d, _peak(q.dtype))


def self_attn_decode(q, k, v, k_scale, v_scale, pos, n_head, anc=None,
                     q_per_kv=1):
    if isinstance(pos, torch.Tensor):
        raise TypeError('self_attn_decode rule: pos must be the host position; '
                        'arithmetic on a device tensor would launch kernels')
    rows, d = q.shape
    b, n = k.shape[0], pos + 1
    kv = 2 * b * n * k.shape[2] * k.element_size()
    sc = 0 if k_scale is None else 2 * b * n * 4
    an = 0 if anc is None else b * n * 4
    return (_b(q) + kv + sc + an + rows * d * 4, 4 * rows * n * d, PEAK_F32)


def cross_attn_decode(q, kv, sc, layer, s, n_head, q_per_kv=1, bits=8):
    rows, d = q.shape
    b = kv.shape[1]
    nbytes = (_b(q) + 2 * b * s * kv.shape[-1] * kv.element_size()
              + 2 * b * s * 4 + rows * d * 4)
    return nbytes, 4 * rows * s * d, PEAK_F32


def cross_attn_decode_indirect(q, kv, sc, bases, layer, s, n_head, bits=8):
    """The direct entry's count: the kernel reads the same rows of the
    buffers whose addresses ``bases`` holds, laid out as ``kv`` and ``sc``."""
    return cross_attn_decode(q, kv, sc, layer, s, n_head, 1, bits)


def fused_logit_aggregates(x, emb, suppress, ts_silence, flags, ts_begin, eot,
                           with_grammar=True):
    b, d = x.shape
    v = emb.shape[0]
    nbytes = (_b(x) + _b(emb) + _b(suppress) + _b(ts_silence)
              + (_b(flags) if with_grammar else 0) + b * 6 * 4)
    return nbytes, 2 * b * v * d, _peak(emb.dtype)


def vocab_proj(x, emb):
    m, d = x.shape
    v = emb.shape[0]
    return _b(x) + _b(emb) + m * v * 4, 2 * m * v * d, _peak(emb.dtype)


def woq_matmul(x, q, scale, bias=None):
    m = x.numel() // x.shape[-1]
    n, k = q.shape
    out = m * n * x.element_size()
    return (_b(x) + _b(q) + _b(scale) + _b(bias) + out, 2 * m * n * k,
            _peak(x.dtype))


def dtw_cost(x):
    *batch, n, m = x.shape
    b = batch[0] if batch else 1
    return _b(x) + b * (n + 1) * (m + 1) * 4, 3 * b * n * m, PEAK_F32


# (module under stable_ts_tpu_torch.ops, wrapper) -> rule
RULES = {
    ('flash_attn', 'flash_attention'): flash_attention,
    ('self_attn', 'self_attn_decode'): self_attn_decode,
    ('cross_attn', 'cross_attn_decode'): cross_attn_decode,
    ('cross_attn', 'cross_attn_decode_indirect'): cross_attn_decode_indirect,
    ('logit_epilogue', 'fused_logit_aggregates'): fused_logit_aggregates,
    ('vocab_proj', 'vocab_proj'): vocab_proj,
    ('woq_matmul', 'woq_matmul'): woq_matmul,
    ('dtw', 'dtw_cost'): dtw_cost,
}

# (module, wrapper) -> the kernels (csrc/) its calls launch, by function
# name, by which a CUDA graph's replayed kernels are matched to the wrapper
# calls its capture made
KERNELS = {
    ('flash_attn', 'flash_attention'): ('flash_fwd_kernel', 'flash_fwd_wgmma'),
    ('self_attn', 'self_attn_decode'): ('decode_attn_kernel',),
    ('cross_attn', 'cross_attn_decode'): ('cross_cluster_kernel',),
    ('cross_attn', 'cross_attn_decode_indirect'): ('cross_cluster_kernel',),
    ('logit_epilogue', 'fused_logit_aggregates'): (
        'epilogue_partial_kernel', 'epilogue_wgmma', 'epilogue_merge_kernel'),
    ('vocab_proj', 'vocab_proj'): ('vocab_proj_wgmma', 'vocab_proj_kernel'),
    ('woq_matmul', 'woq_matmul'): ('woq_wgmma_kernel', 'woq_gemv_kernel',
                                   'woq_tiled_kernel'),
    ('dtw', 'dtw_cost'): ('dtw_cost_kernel',),
}


def kernel_function(name: str) -> str:
    """The function name of a profiled kernel's demangled name:
    ``void (anonymous namespace)::cross_cluster_kernel<signed char, 64,
    true>(float const*, ...)`` gives ``cross_cluster_kernel``."""
    head = re.split(r'[<(]', name.replace('(anonymous namespace)::', ''), 1)[0]
    return re.split(r'[\s:]+', head.strip())[-1]
