"""The flash twins in bf16 against the Pallas flash-attention kernels run in
TPU interpret mode on the CPU: the forward and its VJP (dq, dk, dv), called
as stable_ts_tpu/models/whisper/model.py calls them (heads split, the
sequences padded to 128 and masked with segment ids, the same BlockSizes),
2 heads of 64, at an encoder-like self shape (T = S = 200) and a cross
shape (T = 37 tokens against S = 200 frames). Inputs from numpy seeds,
rounded to bf16 alike in both frameworks.

The twins round where the Pallas kernels round (P before P V; P and the
scaled dS before the second backward products; the outputs), so what is
left is f32 sums in another order and exp in another library. An output
that sits at a rounding boundary can then land on the neighbouring bf16,
so each tensor is held within two bf16 ulps of its largest magnitude."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)
H, DH = 2, 64
SHAPES = {'self': (200, 200), 'cross': (37, 200)}


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (round to nearest even), held in f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(t, s):
    rng = np.random.default_rng(t * 1000 + s)
    q, do = (_bf16(rng.standard_normal((1, t, H * DH)).astype(np.float32))
             for _ in range(2))
    k, v = (_bf16(rng.standard_normal((1, s, H * DH)).astype(np.float32))
            for _ in range(2))
    return q, k, v, do


def _block_sizes(kind, tp, sp):
    from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes
    if kind == 'self':   # model.py:269-277
        bp = min(sp, 512)
        return BlockSizes(block_q=sp, block_k_major=sp, block_k=sp, block_b=1,
                          block_q_major_dkv=bp, block_k_major_dkv=bp,
                          block_k_dkv=bp, block_q_dkv=bp,
                          block_k_major_dq=bp, block_k_dq=bp, block_q_dq=bp)
    bq, bk = min(tp, 512), min(sp, 1536)   # model.py:365-371
    return BlockSizes(block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
                      block_q_major_dkv=min(tp, 512), block_k_major_dkv=min(sp, 512),
                      block_k_dkv=min(sp, 512), block_q_dkv=min(tp, 512),
                      block_k_major_dq=min(sp, 512), block_k_dq=min(sp, 512),
                      block_q_dq=min(tp, 512))


@functools.lru_cache(maxsize=None)
def _pallas(kind):
    """(out, dq, dk, dv) of the Pallas kernels in interpret mode, f32
    arrays of the port's (B, rows, H * DH) layout."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import (SegmentIds,
                                                                 flash_attention)
    t, s = SHAPES[kind]
    q, k, v, do = _inputs(t, s)
    pad_t, pad_s = (-t) % 128, (-s) % 128

    def heads(x, pad):
        x = x.reshape(1, x.shape[1], H, DH).transpose(0, 2, 1, 3)
        return jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))), jnp.bfloat16)

    def seg(n, pad):
        return jnp.asarray(np.pad(np.ones((1, n), np.int32), ((0, 0), (0, pad)),
                                  constant_values=2))

    ids = SegmentIds(seg(t, pad_t), seg(s, pad_s))
    bs = _block_sizes(kind, t + pad_t, s + pad_s)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: flash_attention(
            a, b, c, segment_ids=ids, sm_scale=DH ** -0.5, block_sizes=bs),
            heads(q, pad_t), heads(k, pad_s), heads(v, pad_s))
        grads = vjp(heads(do, pad_t))

    def merge(x, n):
        x = np.asarray(x.astype(jnp.float32))[:, :, :n]
        return x.transpose(0, 2, 1, 3).reshape(1, n, H * DH)

    return (merge(out, t), *(merge(g, n) for g, n in zip(grads, (t, s, s))))


@functools.lru_cache(maxsize=None)
def _port(kind):
    """(out, dq, dk, dv) of the port's twins in bf16 (the autograd function
    on CPU tensors), as f32 arrays."""
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention
    t, s = SHAPES[kind]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(t, s))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, H, DH ** -0.5)
    assert out.dtype == torch.bfloat16
    out.backward(do)
    return tuple(x.float().numpy() for x in (out.detach(), *(y.grad for y in leaves)))


@pytest.mark.parametrize('kind', sorted(SHAPES))
@pytest.mark.parametrize('index,name', enumerate(['out', 'dq', 'dk', 'dv']))
def test_bf16_twin_matches_pallas_interpret(kind, index, name):
    got, ref = _port(kind)[index], _pallas(kind)[index]
    assert got.shape == ref.shape
    top = np.abs(ref).max()
    assert top > 0
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)   # bf16 spacing at the max
    err = np.abs(got - ref).max()
    assert err <= 2 * ulp, f'{kind} {name}: {err} > 2 ulp ({2 * ulp}) of max {top}'
