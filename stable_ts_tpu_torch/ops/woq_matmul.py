"""The int8 weight-only matmul of ``dq`` models (kernel Q,
``csrc/woq_matmul.cu``).

Replaces stable_ts_tpu/ops/woq_matmul.py:_kernel (``int8_matmul``): the
product of every quantized linear, ``(x @ q^T) * scale`` with f32
accumulation and the per-output-channel scale applied after the K-sum,
then the bias and a cast to x's dtype as stable_ts_tpu's ``linear`` does
(model.py:106-113). The weight stays int8 in device memory, in torch's
(N, K) layout. For bf16 x the kernel widens each weight tile exactly to
bf16 in registers and runs the products on the tensor cores (wgmma), K
split across a thread-block cluster where the output alone would not fill
the card; f32 x takes CUDA-core kernels (see the source note).
"""
import torch

from .. import _build


def woq_matmul_ref(x, q, scale) -> torch.Tensor:
    """Plain twin: (M, K) f32/bf16 x (N, K) int8 with (N,) f32 scales ->
    (M, N) f32."""
    return (x.float() @ q.float().t()) * scale


def woq_matmul(x, q, scale, bias=None) -> torch.Tensor:
    """``(x @ q^T) * scale + bias`` in x's dtype. x: (..., K) f32 or bf16;
    q: (N, K) int8; scale: (N,) f32; bias: (N,) or None. A CPU tensor goes
    to the plain twin, a CUDA tensor to the kernel."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if x.device.type == 'cpu':
        out = woq_matmul_ref(x2, q, scale)
    elif x.device.type == 'cuda':
        out = _woq_cuda(x2, q, scale)
    else:
        raise ValueError(f'woq_matmul: unsupported device {x.device}')
    if bias is not None:
        out = out + bias
    return out.to(x.dtype).reshape(*lead, q.shape[0])


def _woq_cuda(x, q, scale) -> torch.Tensor:
    m, k = x.shape
    n = q.shape[0]
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != k or not q.is_contiguous():
        raise TypeError(f'woq_matmul: the weight must be contiguous int8 (N, {k}), '
                        f'got {q.dtype} {tuple(q.shape)}')
    if k % 16:
        raise ValueError(f'woq_matmul: K = {k} must be a multiple of 16 '
                         '(16-byte weight rows)')
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (n,)
            or not scale.is_contiguous()):
        raise ValueError(f'woq_matmul: scale must be contiguous f32 ({n},)')
    if not (x.device == q.device == scale.device):
        raise ValueError('woq_matmul: operands must share a device')
    x = x.contiguous()
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError('woq_matmul: operands must be 16-byte aligned')
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().woq_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _build.dtype_code(x.dtype), m, n, k, _build.stream_ptr(x)), 'woq_matmul')
    _build.launches['woq_matmul'] += 1
    return out
