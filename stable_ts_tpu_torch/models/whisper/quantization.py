"""int8 weight-only quantization of the Whisper linears (port of
stable_ts_tpu/models/whisper/quantization.py).

- **Weight-only, symmetric, per output channel.** Each q/k/v/out/fc1/fc2
  weight becomes int8 plus one f32 scale per output channel (amax / 127,
  half-to-even rounding, clipped to [-127, 127]); activations stay float.
  :class:`QuantizedLinear` holds it in torch's (out, in) layout and
  multiplies through the weight-only kernel (``ops/woq_matmul.py``), which
  applies the scale after the K-sum.
- As in the JAX package (``_LINEAR_KEYS``), conv stems, embeddings and
  layer norms are not quantized.

:func:`quantize_tensor` is the activation counterpart (the cross K/V per
position), with ``bits=4`` snapping to the int4 grid ([-7, 7], amax / 7)
and returning unpacked int8 values.
"""
import torch
from torch import nn

from ...ops.woq_matmul import woq_matmul

LINEAR_KEYS = ('q', 'k', 'v', 'out', 'fc1', 'fc2')


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


class QuantizedLinear(nn.Module):
    """A linear with an int8 (out, in) weight, f32 per-output scales and an
    optional float bias; ``forward`` is ``(x @ weight^T) * scale + bias``
    in x's dtype, through the weight-only kernel."""

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
        return woq_matmul(x, self.weight, self.scale, self.bias)

    def extra_repr(self) -> str:
        out_f, in_f = self.weight.shape
        return f'in_features={in_f}, out_features={out_f}, int8'


def _linears(model):
    """(parent module, name) of every quantizable linear of both stacks."""
    for stack in (model.encoder, model.decoder):
        for blk in stack.blocks:
            for attn in ('attn', 'cross_attn'):
                if hasattr(blk, attn):
                    for proj in ('q', 'k', 'v', 'out'):
                        yield getattr(blk, attn), proj
            for fc in ('fc1', 'fc2'):
                yield blk.mlp, fc


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
