"""Median filter over the last axis (port of stable_ts_tpu/ops/median.py).

whisper.timing.median_filter's semantics: reflect-pad by half the width,
then the exact median of each sliding window. Plain torch (sort of a
(…, frames, width) view); the JAX package runs no Pallas kernel here either.
"""
import torch


def reflect_index(length: int, pad: int, device=None) -> torch.Tensor:
    """Source indices of ``np.pad(x, pad, mode='reflect')`` along one axis."""
    idx = torch.arange(-pad, length + pad, device=device)
    idx = idx.abs()
    return torch.where(idx >= length, 2 * (length - 1) - idx, idx)


def median_filter(x: torch.Tensor, filter_width: int = 7) -> torch.Tensor:
    if filter_width <= 0 or filter_width % 2 != 1:
        raise ValueError('`filter_width` should be an odd number')
    if x.shape[-1] <= filter_width // 2:
        return x
    pad = filter_width // 2
    padded = x.index_select(-1, reflect_index(x.shape[-1], pad, x.device))
    windows = padded.unfold(-1, filter_width, 1)        # (..., frames, width)
    return windows.sort(dim=-1).values[..., pad]
