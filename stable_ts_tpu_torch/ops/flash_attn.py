"""Non-causal flash attention: the forward (kernel F, ``csrc/flash_attn.cu``)
and its gradient (``csrc/flash_attn_bwd.cu``).

The forward replaces the TPU's Pallas flash attention at both of its call
sites in stable_ts_tpu/models/whisper/model.py: the encoder's
self-attention (``_flash_self_attention``) and the decoder's
cross-attention (``_flash_cross_attention``). The backward replaces the
Pallas module's ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``,
which its ``custom_vjp`` runs when the train step differentiates those
calls. The (T, S) scores never reach device memory in either direction;
keys beyond S (and, in the backward, query rows beyond T) are masked inside
the kernels instead of by the TPU's segment-id padding. See the kernel
sources for what bounds them and how the designs answer.

Inputs are (B, T, n_head * d_head) projections (views with a contiguous
last axis are fine: the kernels take batch and row strides), so no head
split or merge copies exist. :func:`flash_attention` goes through the
:class:`FlashAttention` autograd function when a gradient is wanted; the
forward then also keeps each row's logsumexp for the backward.
"""
import torch

from .. import _build


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The twins' compute type: f32, or f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _heads(x: torch.Tensor, n_head: int, dtype: torch.dtype) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2).to(dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_head: int, scale: float, return_lse: bool = False):
    """Plain twin: softmax(q k^T * scale) v per head, scores in f32.
    q: (B, T, d); k/v: (B, S, d) -> (B, T, d) in q's dtype; with
    ``return_lse`` also the scores' logsumexp (B, H, T) in f32.

    Rounds where the Pallas kernel rounds (flash_attention.py:471): the
    unnormalised weights P = exp(s - max) go to the inputs' dtype before
    the P V product, the row sum l stays f32, and the output is (P V) / l.
    In f32 (and f64) the rounding is a no-op."""
    b, t, d = q.shape
    acc = _acc_dtype(q.dtype)
    scores = (_heads(q, n_head, acc) @ _heads(k, n_head, acc).transpose(-1, -2)) * scale
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = (p.to(q.dtype).to(acc) @ _heads(v, n_head, acc)) / l
    out = out.transpose(1, 2).reshape(b, t, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def attention_delta(o: torch.Tensor, do: torch.Tensor, n_head: int) -> torch.Tensor:
    """D = sum over d_head of dO * O per (batch, head, query row), in f32:
    (B, H, T). Plain PyTorch on either device: the TPU's wrapper computes
    it outside its kernels too."""
    acc = _acc_dtype(o.dtype)
    return (_heads(do, n_head, acc) * _heads(o, n_head, acc)).sum(-1).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, n_head: int, scale: float,
                            needs=(True, True, True)):
    """Plain twin of the backward, in f32: with P = exp(scale q k^T - lse)
    recomputed, dV = P^T dO, dS = scale P * (dO V^T - D), dQ = dS K and
    dK = dS^T Q. Returns (dq, dk, dv) in q/k/v's dtypes, None where
    ``needs`` is False (dq alone skips dV; dk, dv skip dQ).

    Rounds where the Pallas kernels round (flash_attention.py:900, :918,
    :1258): P and the scaled dS go to the inputs' dtype before the second
    products, whose sums stay f32. In f32 (and f64) that is a no-op."""
    acc = _acc_dtype(q.dtype)
    qh, kh, vh, doh = (_heads(x, n_head, acc) for x in (q, k, v, do))
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse[..., None].to(acc))
    ds = p * (doh @ vh.transpose(-1, -2) - attention_delta(o, do, n_head)[..., None])
    ds = (ds * scale).to(q.dtype).to(acc)

    def merge(x, like):
        return x.transpose(1, 2).reshape(like.shape).to(like.dtype)

    dq = merge(ds @ kh, q) if needs[0] else None
    dk = merge(ds.transpose(-1, -2) @ qh, k) if needs[1] else None
    dv = merge(p.to(q.dtype).to(acc).transpose(-1, -2) @ doh, v) if needs[2] else None
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward saves q, k, v, the
    output and the logsumexp; the backward recomputes the scores from
    them. CPU tensors take the twins, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, n_head: int, scale: float):
        out, lse = _forward(q, k, v, n_head, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_head, ctx.scale = n_head, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand dO expanded (stride 0 after a .sum())
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.n_head, ctx.scale,
                                         ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int, scale: float) -> torch.Tensor:
    """Flash attention forward. A CPU tensor goes to the plain twin, a CUDA
    tensor to the kernel; when autograd records and q, k or v requires a
    gradient, through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, n_head, scale)
    return _forward(q, k, v, n_head, scale)


def flash_attention_bwd(q, k, v, o, lse, do, n_head: int, scale: float,
                        needs=(True, True, True)):
    """(dq, dk, dv) of flash attention (None where ``needs`` is False): the
    twin for CPU tensors, the kernels for CUDA tensors (dO contiguous)."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_ref(q, k, v, o, lse, do, n_head, scale, needs)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention_bwd: unsupported device {q.device}')
    delta = attention_delta(o, do, n_head)
    dq = dk = dv = None
    if needs[1] or needs[2]:
        dk, dv = _bwd_dkv_cuda(q, k, v, lse, do, delta, n_head, scale)
    if needs[0]:
        dq = _bwd_dq_cuda(q, k, v, lse, do, delta, n_head, scale)
    return dq, (dk if needs[1] else None), (dv if needs[2] else None)


def _forward(q, k, v, n_head, scale, return_lse=False):
    if q.device.type == 'cpu':
        return flash_attention_ref(q, k, v, n_head, scale, return_lse=return_lse)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention: unsupported device {q.device}')
    return _flash_cuda(q, k, v, n_head, scale, return_lse=return_lse)


def _check_rows(name, x):
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            st * x.element_size() % 16 for st in x.stride()[:2]):
        raise ValueError(f'flash kernel: {name} needs a contiguous last '
                         f'axis and 16-byte aligned rows')


def _check_qkv(q, k, v, n_head):
    """(B, T, S, d_head) of kernel-ready q/k/v; raises on what the kernels
    do not take."""
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
        _check_rows(name, x)
    return b, t, s, dh


def _flash_cuda(q, k, v, n_head, scale, return_lse=False):
    b, t, s, dh = _check_qkv(q, k, v, n_head)
    out = torch.empty((b, t, n_head * dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, n_head, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _build.check(_build.lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _build.dtype_code(q.dtype), b, n_head, t, s, dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        float(scale), _build.stream_ptr(q)), 'flash_attn_fwd')
    _build.launches['flash_attn'] += 1
    return (out, lse) if return_lse else out


def _check_bwd(q, k, v, lse, do, delta, n_head):
    """The backward's inputs beyond q/k/v: dO contiguous and like q, lse
    and D f32 (B, H, T) contiguous."""
    b, t, s, dh = _check_qkv(q, k, v, n_head)
    if lse is None:
        raise ValueError('flash backward: needs the forward\'s logsumexp')
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f'flash backward: dO must match q, got '
                         f'{tuple(do.shape)} {do.dtype} on {do.device}')
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError('flash backward: dO must be contiguous and 16-byte aligned')
    for name, x in (('lse', lse), ('D', delta)):
        if (x.shape != (b, n_head, t) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f'flash backward: {name} must be contiguous f32 '
                             f'({b}, {n_head}, {t}), got {tuple(x.shape)} '
                             f'{x.dtype}')
    return b, t, s, dh


def _bwd_dkv_cuda(q, k, v, lse, do, delta, n_head, scale):
    b, t, s, dh = _check_bwd(q, k, v, lse, do, delta, n_head)
    dk = torch.empty((b, s, n_head * dh), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    _build.check(_build.lib().flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _build.dtype_code(q.dtype),
        b, n_head, t, s, dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), _build.stream_ptr(q)),
        'flash_attn_bwd_dkv')
    _build.launches['flash_attn_bwd_dkv'] += 1
    return dk, dv


def _bwd_dq_cuda(q, k, v, lse, do, delta, n_head, scale):
    b, t, s, dh = _check_bwd(q, k, v, lse, do, delta, n_head)
    dq = torch.empty((b, t, n_head * dh), dtype=q.dtype, device=q.device)
    _build.check(_build.lib().flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _build.dtype_code(q.dtype),
        b, n_head, t, s, dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), _build.stream_ptr(q)),
        'flash_attn_bwd_dq')
    _build.launches['flash_attn_bwd_dq'] += 1
    return dq
