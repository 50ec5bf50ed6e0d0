"""Megatron tensor parallelism over the mesh's ``tp`` group.

:class:`ColumnParallelLinear` holds the output channels of this rank's
heads (q, k, v, fc1); :class:`RowParallelLinear` holds the matching input
channels (out, fc2), sums the ranks' partial products with an all-reduce
and adds its whole bias once, after the reduce. The pair's conjugate
autograd functions make the backward pass right: the input of a column
linear is copied forward and its gradient all-reduced backward; the output
of a row linear is all-reduced forward and its gradient passed through.
Both wrap the float ``nn.Linear`` or the int8 ``QuantizedLinear`` that
``shard_params`` sliced, so every linear keeps its kernel on its shard.
"""
import torch
import torch.distributed as dist
from torch import nn

from ..models.whisper.quantization import (QuantizedLinear, _woq_mode,
                                           dyn_linear)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToGroup.apply(x, group)
    return x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; in place on ``x`` when no gradient
    is wanted (``x`` is a fresh product)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce_(x, group)


class ColumnParallelLinear(nn.Module):
    """A linear holding the output channels of this rank's heads:
    ``inner(x)``, its input's gradient summed over tp."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner = inner
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner(copy_to_group(x, self.group))


class RowParallelLinear(nn.Module):
    """A linear holding the input channels of this rank's heads: the
    partial product all-reduced over tp, then the whole bias. A ``dyn``
    int8 weight reduces its activation amax and its int32 sums instead
    (:func:`~..models.whisper.quantization.dyn_linear`), exact."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.bias = inner.bias
        inner.bias = None
        self.inner = inner
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inner = self.inner
        if isinstance(inner, QuantizedLinear) and _woq_mode() == 'dyn':
            return dyn_linear(x, inner.weight, inner.scale, self.bias,
                              group=self.group)
        y = reduce_from_group(inner(x), self.group)
        return y if self.bias is None else y + self.bias
