"""int8 weight-only quantization of the Whisper linears (port of
stable_ts_tpu/models/whisper/quantization.py).

- **Weight-only, symmetric, per output channel.** Each q/k/v/out/fc1/fc2
  weight becomes int8 plus one f32 scale per output channel (amax / 127,
  half-to-even rounding, clipped to [-127, 127]); activations stay float.
  :class:`QuantizedLinear` holds it in torch's (out, in) layout and
  multiplies through the weight-only kernel (``ops/woq_matmul.py``), which
  applies the scale after the K-sum.
- **``dyn``**, the int8 x int8 recipe of stable_ts_tpu's ``linear``
  (models/whisper/model.py:64-104, its default on the TPU), runs when
  ``STABLE_TS_TPU_WOQ`` is ``dyn``, ``1``, ``on`` or ``true``
  (:func:`dyn_linear`): the activations are quantized per row to int8 and
  the product takes int32 sums against the int8 weight. Every other value
  keeps the weight-only kernel.
- As in the JAX package (``_LINEAR_KEYS``), conv stems, embeddings and
  layer norms are not quantized.

:func:`quantize_tensor` is the activation counterpart (the cross K/V per
position), with ``bits=4`` snapping to the int4 grid ([-7, 7], amax / 7)
and returning unpacked int8 values.
"""
import os

import torch
import torch.distributed as dist
from torch import nn

from ...ops.woq_matmul import woq_matmul

LINEAR_KEYS = ('q', 'k', 'v', 'out', 'fc1', 'fc2')
# torch._int_mm on a CUDA tensor (cuBLASLt's int8 tensor-core product) takes
# more than 16 rows; fewer are padded with zero rows and sliced off (about
# 0.002 ms a call on an H100 80GB HBM3 at 700 W: PERF.md, the dyn rows)
INT_MM_MIN_ROWS = 17


def quantize_tensor(x: torch.Tensor, reduce_axis: int = -1, bits: int = 8):
    """Symmetric int``bits`` quantization with one scale per slice along
    ``reduce_axis``. Returns (int8 values, f32 scales keeping the reduced
    axis as size 1): amax / (2**(bits-1) - 1), 1 where amax is 0."""
    qmax = float(2 ** (bits - 1) - 1)
    x32 = x.float()
    amax = x32.abs().amax(dim=reduce_axis, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor):
    """(out, in) weight -> (int8 (out, in), f32 scales (out,)): one scale per
    output channel, reduced over the input axis (JAX's (in, out) weight
    reduces its axis -2; the values are the same)."""
    q, scale = quantize_tensor(w, reduce_axis=-1, bits=8)
    return q, scale[..., 0]


def _woq_mode() -> str:
    """How quantized linears multiply, from stable_ts_tpu's own switch
    (model.py:64-81): 'dyn' for ``STABLE_TS_TPU_WOQ`` = dyn, 1, on or true;
    'woq' (the weight-only kernel, ``ops/woq_matmul.py``) for any other
    value or none."""
    pref = os.environ.get('STABLE_TS_TPU_WOQ', 'auto')
    return 'dyn' if pref in ('dyn', '1', 'on', 'true') else 'woq'


def quantize_rows(t: torch.Tensor, bits: int = 8, group=None):
    """Per-row symmetric int``bits`` over the last axis: (..., d) -> int8
    values (..., d) and f32 scales (...,). Half-to-even rounding, as
    jnp.round. The scale is amax times the f32 reciprocal of the grid's
    top, not amax divided by it: the JAX functions that quantize cache rows
    and ``dyn``'s activations are compiled, and XLA folds the division by
    the constant into that multiply, so the two packages round the same
    values to the same codes. ``group``: the tp group over which the rows'
    last axis is split (a rank holds ``d / tp`` of each row); the amax is
    all-reduced (MAX) over it, so the scale and the codes are the whole
    row's."""
    qmax = float(2 ** (bits - 1) - 1)
    t32 = t.float()
    amax = t32.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    sc = torch.where(amax > 0, amax * torch.tensor(1.0 / qmax, dtype=torch.float32),
                     torch.ones_like(amax))
    q = torch.clamp(torch.round(t32 / sc), -qmax, qmax).to(torch.int8)
    return q, sc[..., 0]


def int8_mm(xq: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32 sums, exact. On a CUDA
    tensor ``torch._int_mm`` with the rows padded to ``INT_MM_MIN_ROWS``
    (it raises on a K or N that is not a multiple of 8); on the CPU the
    same call takes any shape."""
    m = xq.shape[0]
    if xq.device.type == 'cuda' and m < INT_MM_MIN_ROWS:
        padded = xq.new_zeros((INT_MM_MIN_ROWS, xq.shape[1]))
        padded[:m] = xq
        return torch._int_mm(padded, weight.t())[:m]
    return torch._int_mm(xq, weight.t())


def dyn_linear(x, weight, scale, bias=None, group=None) -> torch.Tensor:
    """stable_ts_tpu's ``dyn`` linear (model.py:93-104): x quantized per
    row to int8 (:func:`quantize_rows`), int32 sums against the (N, K) int8
    weight, then ``(sums * row scale) * column scale + bias`` in f32, cast
    to x's dtype. ``group``: the tp group of a row-split weight (this rank
    holds K / tp of x's row and of the weight's input channels): the row's
    amax and the int32 partial sums are all-reduced over it before the
    scalings, which keeps the sums exact, as XLA's int32 product is."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, k), group=group)
    sums = int8_mm(xq, weight)
    if group is not None:
        dist.all_reduce(sums, group=group)
    out = sums.float() * xs[:, None] * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype).reshape(*lead, weight.shape[0])


class QuantizedLinear(nn.Module):
    """A linear with an int8 (out, in) weight, f32 per-output scales and an
    optional float bias; ``forward`` is ``(x @ weight^T) * scale + bias``
    in x's dtype, through the weight-only kernel, or the ``dyn`` recipe
    when ``STABLE_TS_TPU_WOQ`` selects it."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor = None):
        super().__init__()
        self.register_buffer('weight', weight)
        self.register_buffer('scale', scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> 'QuantizedLinear':
        q, scale = quantize_weight(linear.weight.detach())
        bias = None if linear.bias is None else linear.bias.detach()
        return cls(q, scale, bias)

    @classmethod
    def empty_like(cls, linear: nn.Linear) -> 'QuantizedLinear':
        """Uninitialised buffers of ``linear``'s shape, for loading."""
        dev = linear.weight.device
        out_f, in_f = linear.weight.shape
        bias = None if linear.bias is None else torch.empty_like(linear.bias)
        return cls(torch.empty((out_f, in_f), dtype=torch.int8, device=dev),
                   torch.empty(out_f, dtype=torch.float32, device=dev), bias)

    def dequantized(self, dtype: torch.dtype) -> nn.Linear:
        """A plain linear holding ``q * scale``, both cast to ``dtype``
        first, as the JAX package's ``QuantizedArray.dequantize``."""
        out_f, in_f = self.weight.shape
        lin = nn.Linear(in_f, out_f, bias=self.bias is not None,
                        device=self.weight.device, dtype=dtype)
        with torch.no_grad():
            lin.weight.copy_(self.weight.to(dtype) * self.scale.to(dtype)[:, None])
            if self.bias is not None:
                lin.bias.copy_(self.bias)
        return lin.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _woq_mode() == 'dyn':
            return dyn_linear(x, self.weight, self.scale, self.bias)
        return woq_matmul(x, self.weight, self.scale, self.bias)

    def extra_repr(self) -> str:
        out_f, in_f = self.weight.shape
        return f'in_features={in_f}, out_features={out_f}, int8'


def _linears(model):
    """(parent module, name) of every quantizable linear of both stacks;
    the parent of a tensor-parallel linear's is its wrapper
    (``parallel/tensor_parallel.py``)."""
    for stack in (model.encoder, model.decoder):
        for blk in stack.blocks:
            for attn in ('attn', 'cross_attn'):
                if hasattr(blk, attn):
                    for proj in ('q', 'k', 'v', 'out'):
                        yield _unwrapped(getattr(blk, attn), proj)
            for fc in ('fc1', 'fc2'):
                yield _unwrapped(blk.mlp, fc)


def _unwrapped(parent, name):
    lin = getattr(parent, name)
    return (lin, 'inner') if hasattr(lin, 'inner') else (parent, name)


def is_quantized(model) -> bool:
    return any(isinstance(getattr(parent, name), QuantizedLinear)
               for parent, name in _linears(model))


@torch.no_grad()
def quantize_params(model, empty: bool = False):
    """Swap exactly the q/k/v/out/fc1/fc2 linears of both stacks of a
    :class:`~.model.Whisper` for :class:`QuantizedLinear`, in place, on
    the model's device (``empty``: uninitialised, for a loader to fill).
    Linears already quantized stay. Returns the model."""
    make = QuantizedLinear.empty_like if empty else QuantizedLinear.from_linear
    for parent, name in _linears(model):
        lin = getattr(parent, name)
        if isinstance(lin, nn.Linear):
            setattr(parent, name, make(lin))
    return model


@torch.no_grad()
def dequantize_params(model, dtype: torch.dtype = None):
    """Inverse of :func:`quantize_params` (lossy): plain linears holding
    ``q * scale``, in ``dtype`` (default: the token embedding's). In
    place; returns the model."""
    dtype = dtype or model.decoder.token_emb.dtype
    for parent, name in _linears(model):
        lin = getattr(parent, name)
        if isinstance(lin, QuantizedLinear):
            setattr(parent, name, lin.dequantized(dtype))
    return model


def quantized_bytes(model) -> int:
    """Bytes of every parameter and buffer at its stored width (int8
    weights at 1 byte, their f32 scales at 4)."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))
