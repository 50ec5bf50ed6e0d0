"""Self-attention for one decode step (kernel D's self entries,
``csrc/decode_attn.cu``).

Replaces stable_ts_tpu/ops/self_attn.py:_kernel (``self_attn_decode``, the
non-beam path) and :_kernel_beam (the beam path, ``anc`` given). The query
at position ``pos`` attends keys j <= pos of one layer's row-major cache
(B, C, d): int8 rows with per-position scales (the decode path's cache), or
bf16/f32 rows. The kernels read each row once with 16-byte loads and
dequantize in registers; no dequantized copy of the cache exists. The math
is f32 throughout, as in the XLA cache path that stable_ts_tpu takes off
the TPU (model.py:752-780).

Beam search keeps every row's K/V where the step wrote it and reshuffles
only an ancestry table: with ``anc`` (B, C) int32 and g beams per window,
row r reads key j from cache row (r // g) * g + anc[r, j]. The beam kernel
takes any g that divides B and any pos < 8192 (its scores live in shared
memory); it raises outside them and never falls back.

Cache layout (the port's): k, v (L, B, C, d); k_scale, v_scale (L, B, C).
"""
import torch

from .. import _build

MAX_KEYS = 8192         # scores of one (row, head) in shared memory
MAX_KEYS_GROUP = 6144   # 8 query rows' scores per block (cross group entry)


def _by_ancestor(t, anc, g: int, n: int):
    """(B, C, ...) cache rows gathered by ancestry: out[r, j] = t[(r // g)
    * g + anc[r, j], j] for j < n (JAX's XLA path, model.py:767-773)."""
    b = t.shape[0]
    grp = t[:, :n].reshape(b // g, g, n, *t.shape[2:])
    idx = anc[:, :n].long().reshape(b // g, g, n)
    idx = idx.reshape(*idx.shape, *([1] * (t.dim() - 2))).expand(
        b // g, g, n, *t.shape[2:])
    return grp.gather(1, idx).reshape(b, n, *t.shape[2:])


def self_attn_decode_ref(q, k, v, k_scale, v_scale, pos: int, n_head: int,
                         anc=None, q_per_kv: int = 1) -> torch.Tensor:
    """Plain twin. q: (B, d) f32, already scaled by d_head**-0.5; k/v:
    one layer's (B, C, d) cache; k_scale/v_scale: (B, C) or None; anc:
    (B, C) int32 ancestry with q_per_kv beams per window, or None.
    Returns (B, d) f32."""
    b, d = q.shape
    dh = d // n_head
    n = pos + 1
    if anc is not None:
        k, v = (_by_ancestor(t, anc, q_per_kv, n) for t in (k, v))
        if k_scale is not None:
            k_scale, v_scale = (_by_ancestor(t, anc, q_per_kv, n)
                                for t in (k_scale, v_scale))
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


def self_attn_decode(q, k, v, k_scale, v_scale, pos: int, n_head: int,
                     anc=None, q_per_kv: int = 1) -> torch.Tensor:
    """One decode step of self-attention against one layer's cache; the
    current token's row must already be written at ``pos`` (and, with
    ``anc``, ``anc[:, pos]`` must be each row's own local index). A CPU
    tensor goes to the plain twin, a CUDA tensor to the kernel (the beam
    entry when ``anc`` is given)."""
    if q.device.type == 'cpu':
        return self_attn_decode_ref(q, k, v, k_scale, v_scale, pos, n_head,
                                    anc, q_per_kv)
    if q.device.type != 'cuda':
        raise ValueError(f'self_attn_decode: unsupported device {q.device}')
    if anc is not None:
        return _decode_cuda('self_attn_decode_beam', q, k, v, k_scale, v_scale,
                            pos + 1, n_head, g=q_per_kv, anc=anc)
    return _decode_cuda('self_attn_decode', q, k, v, k_scale, v_scale,
                        pos + 1, n_head)


def _decode_cuda(entry, q, k, v, k_scale, v_scale, n_keys, n_head, g=1,
                 anc=None):
    """Launch one of decode_attn.cu's entries. k/v: (B, S, d) views whose
    rows are contiguous (batch and row strides are passed through);
    scales: (B, S) views with unit stride along S, or None. The group entry
    takes B * g query rows; the beam entry takes ``anc`` (B, >= n_keys)
    int32 with unit stride along keys."""
    rows, d = q.shape
    dh = d // n_head
    group = entry == 'cross_attn_decode_group'
    if dh not in (32, 64) or d != n_head * dh:
        raise ValueError(f'decode kernel takes d_head 32 or 64, got d={d} '
                         f'with {n_head} heads')
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise TypeError('decode kernel takes a contiguous f32 query')
    if k.dtype != v.dtype or k.stride() != v.stride() or k.shape != v.shape:
        raise ValueError('decode kernel: k and v must share dtype and layout')
    b = k.shape[0]
    if (rows != (b * g if group else b) or k.shape[2] != d
            or not 1 <= n_keys <= k.shape[1]):
        raise ValueError(f'decode kernel: cache {tuple(k.shape)} for query '
                         f'{tuple(q.shape)}, {n_keys} keys, g={g}')
    limit = MAX_KEYS_GROUP if group else MAX_KEYS
    if n_keys > limit:
        raise ValueError(f'{entry} holds at most {limit} keys, got {n_keys}')
    if g < 1 or (anc is not None and b % g):
        raise ValueError(f'{entry}: g={g} must divide the {b} cache rows')
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
    extra = ()
    if anc is not None:
        if (anc.dtype != torch.int32 or anc.shape[0] != b
                or anc.shape[1] < n_keys or anc.stride(1) != 1
                or anc.device != q.device):
            raise ValueError('decode kernel: anc must be int32 (B, >= n_keys) '
                             'rows on the query\'s device')
        extra = (anc.data_ptr(), anc.stride(0), g)
    elif group:
        extra = (g,)
    out = torch.empty((rows, d), dtype=torch.float32, device=q.device)
    fn = getattr(_build.lib(), entry)
    _build.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), _build.dtype_code(k.dtype), b, n_head, dh, n_keys,
        k.stride(0), k.stride(1), sc_bs, *extra, _build.stream_ptr(q)), entry)
    _build.launches[entry] += 1
    return out
