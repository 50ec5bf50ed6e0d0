"""The plain twins of the port's attention kernels against stable_ts_tpu on
the CPU: flash attention vs ``qkv_attention`` over pad-masked keys, the
self-attention decode vs ``self_attn_decode`` (Pallas, interpret mode), its
beam entry vs JAX's XLA ancestry gather and the Pallas beam kernel, and the
cross-attention decode vs ``cross_attn_decode`` (interpret mode) with one
and with g query rows per window, with int8 and float caches."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

D, H = 64, 2           # tiny_test_dims width and heads
DH = D // H


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _quantize_np(x):
    """Per-row int8 over the last axis, as model.py quantizes caches."""
    amax = np.abs(x).max(-1, keepdims=True)
    sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc[..., 0]


@pytest.mark.parametrize('t,s', [(37, 150), (1, 1500), (130, 64)])
def test_flash_twin_matches_masked_qkv_attention(t, s):
    """JAX pads keys and masks the pad (the TPU flash kernel's segment ids);
    the port's kernel and twin take the real keys only."""
    from stable_ts_tpu.models.whisper.model import qkv_attention
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, t, D)).astype(np.float32)
    k = rng.standard_normal((2, s, D)).astype(np.float32)
    v = rng.standard_normal((2, s, D)).astype(np.float32)
    s_pad = (s + 127) // 128 * 128
    pad = ((0, 0), (0, s_pad - s), (0, 0))
    mask = np.where(np.arange(s_pad) < s, 0.0, -np.inf).astype(np.float32)
    ref, _ = qkv_attention(jnp.asarray(q), jnp.asarray(np.pad(k, pad)),
                           jnp.asarray(np.pad(v, pad)), H, mask=jnp.asarray(mask))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), H, DH ** -0.5)
    assert got.shape == (2, t, D)
    assert _rel_err(got.numpy(), ref) <= 1e-5  # f32; sums' order differs


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('pos', [0, 57, 127])
def test_self_decode_twin_matches_pallas_interpret(int8, pos):
    from stable_ts_tpu.ops.self_attn import self_attn_decode as sa_jax
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode
    rng = np.random.default_rng(12 + pos)
    layers, b, ctx, layer = 3, 2, 128, 1
    k = rng.standard_normal((layers, b, ctx, D)).astype(np.float32)
    v = rng.standard_normal((layers, b, ctx, D)).astype(np.float32)
    q = (rng.standard_normal((b, D)) * DH ** -0.5).astype(np.float32)
    if int8:
        k, ks = _quantize_np(k)
        v, vs = _quantize_np(v)
    else:
        ks = vs = np.ones((layers, b, ctx), np.float32)
    ref = sa_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer, pos, H,
                 ks=jnp.asarray(ks[:, :, None]), vs=jnp.asarray(vs[:, :, None]),
                 interpret=True)
    scales = ((torch.from_numpy(ks[layer]), torch.from_numpy(vs[layer]))
              if int8 else (None, None))
    got = self_attn_decode(torch.from_numpy(q), torch.from_numpy(k[layer]),
                           torch.from_numpy(v[layer]), *scales, pos, H)
    # The TPU kernel feeds its MXU bf16 operands for an int8 cache (the query
    # and the weights round to bf16, self_attn.py:106); the port computes in
    # f32 like the XLA cache path the JAX package takes off the TPU, so the
    # int8 case agrees to bf16 rounding, the float case to f32 rounding.
    assert _rel_err(got.numpy(), ref) <= (1e-2 if int8 else 1e-5)


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('s', [100, 700])
def test_cross_decode_twin_matches_pallas_interpret(int8, s, monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    from stable_ts_tpu.ops.cross_attn import cross_attn_decode as ca_jax
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode
    rng = np.random.default_rng(13 + s)
    layers, b, layer = 2, 2, 1
    kv = rng.standard_normal((layers, b, 2, s, D)).astype(np.float32)
    q = (rng.standard_normal((b, D)) * DH ** -0.5).astype(np.float32)
    if int8:
        kv, sc = _quantize_np(kv)
    else:
        sc = np.ones((layers, b, 2, s), np.float32)
    s_pad = (s + 511) // 512 * 512
    kvt = np.zeros((layers, b, 2, D, s_pad), kv.dtype)
    kvt[..., :s] = kv.transpose(0, 1, 2, 4, 3)
    sct = np.ones((layers, b, 2, 1, s_pad), np.float32)
    sct[:, :, :, 0, :s] = sc
    ref = ca_jax(jnp.asarray(q), jnp.asarray(kvt), jnp.asarray(sct), H, s=s,
                 layer_idx=layer)
    got = cross_attn_decode(torch.from_numpy(q), torch.from_numpy(kv),
                            torch.from_numpy(sc), layer, s, H)
    # both round the query and the weights to bf16 at the same places; what
    # remains is f32 summation order (and, rarely, a weight whose last f32
    # bit rounds it to the neighbouring bf16 value)
    assert _rel_err(got.numpy(), ref) <= 1e-4


def _transposed_kv(kv, sc, s):
    """The port's (L, B, 2, S, d) K/V and (L, B, 2, S) scales in JAX's
    transposed, 512-padded layout."""
    layers, b, _, _, d = kv.shape
    s_pad = (s + 511) // 512 * 512
    kvt = np.zeros((layers, b, 2, d, s_pad), kv.dtype)
    kvt[..., :s] = kv.transpose(0, 1, 2, 4, 3)
    sct = np.ones((layers, b, 2, 1, s_pad), np.float32)
    sct[:, :, :, 0, :s] = sc
    return jnp.asarray(kvt), jnp.asarray(sct)


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('g', [2, 5])
def test_cross_decode_group_twin_matches_pallas_interpret(int8, g, monkeypatch):
    """q_per_kv = g: rows b*g ... b*g+g-1 read window b's K/V."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    from stable_ts_tpu.ops.cross_attn import cross_attn_decode as ca_jax
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode
    rng = np.random.default_rng(14 + g)
    layers, windows, layer, s = 2, 3, 1, 300
    kv = rng.standard_normal((layers, windows, 2, s, D)).astype(np.float32)
    q = (rng.standard_normal((windows * g, D)) * DH ** -0.5).astype(np.float32)
    if int8:
        kv, sc = _quantize_np(kv)
    else:
        sc = np.ones((layers, windows, 2, s), np.float32)
    kvt, sct = _transposed_kv(kv, sc, s)
    ref = ca_jax(jnp.asarray(q), kvt, sct, H, s=s, q_per_kv=g, layer_idx=layer)
    got = cross_attn_decode(torch.from_numpy(q), torch.from_numpy(kv),
                            torch.from_numpy(sc), layer, s, H, q_per_kv=g)
    # the bf16 rounding points of the g = 1 branch (cross_attn.py:118-120, 129)
    assert _rel_err(got.numpy(), ref) <= 1e-4
    # the same as g = 1 against each row's own copy of its window's K/V
    rep = cross_attn_decode(torch.from_numpy(q),
                            torch.from_numpy(kv).repeat_interleave(g, dim=1),
                            torch.from_numpy(sc).repeat_interleave(g, dim=1),
                            layer, s, H)
    assert _rel_err(got.numpy(), rep.numpy()) <= 1e-6


def _beam_case(seed, int8, g, pos, groups=2, layers=3, ctx=128):
    """A seeded beam cache and an ancestry table with every row's history
    drawn from random siblings (anc[:, pos] = the row's own index)."""
    rng = np.random.default_rng(seed)
    b = groups * g
    k = rng.standard_normal((layers, b, ctx, D)).astype(np.float32)
    v = rng.standard_normal((layers, b, ctx, D)).astype(np.float32)
    q = (rng.standard_normal((b, D)) * DH ** -0.5).astype(np.float32)
    if int8:
        (k, ks), (v, vs) = _quantize_np(k), _quantize_np(v)
    else:
        ks = vs = np.ones((layers, b, ctx), np.float32)
    anc = rng.integers(0, g, (b, ctx)).astype(np.int32)
    anc[:, pos] = np.arange(b) % g
    return q, k, v, ks, vs, anc


def _port_beam(q, k, v, ks, vs, anc, layer, pos, g, int8):
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode
    scales = ((torch.from_numpy(ks[layer]), torch.from_numpy(vs[layer]))
              if int8 else (None, None))
    return self_attn_decode(torch.from_numpy(q), torch.from_numpy(k[layer]),
                            torch.from_numpy(v[layer]), *scales, pos, H,
                            anc=torch.from_numpy(anc), q_per_kv=g).numpy()


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('g,pos', [(2, 0), (3, 57), (5, 127)])
def test_self_decode_beam_twin_matches_xla_gather(int8, g, pos):
    """Against JAX's XLA path: dequantize the layer slab, gather each row's
    keys by ancestor (model.py:763-776), attend in f32. Within 1e-5."""
    from stable_ts_tpu.models.whisper.model import qkv_attention
    q, k, v, ks, vs, anc = _beam_case(20 + pos, int8, g, pos)
    layer, n = 1, pos + 1
    b = q.shape[0]

    def by_ancestor(slab):     # model.py:767-773
        grp = slab.reshape(b // g, g, n, -1)
        idx = jnp.asarray(anc[:, :n]).reshape(b // g, g, n)[..., None]
        return jnp.take_along_axis(grp, idx, axis=1).reshape(b, n, -1)

    k_slab = jnp.asarray(k[layer, :, :n].astype(np.float32) * ks[layer, :, :n, None])
    v_slab = jnp.asarray(v[layer, :, :n].astype(np.float32) * vs[layer, :, :n, None])
    ref, _ = qkv_attention(jnp.asarray(q / DH ** -0.5)[:, None], by_ancestor(k_slab),
                           by_ancestor(v_slab), H)
    got = _port_beam(q, k, v, ks, vs, anc, layer, pos, g, int8)
    assert _rel_err(got, np.asarray(ref)[:, 0]) <= 1e-5


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('g,pos', [(2, 5), (5, 100)])
def test_self_decode_beam_twin_matches_pallas_interpret(int8, g, pos):
    """Against the Pallas beam kernel (_kernel_beam) in interpret mode. For
    an int8 cache the TPU kernel feeds its MXU bf16 query and weights
    (self_attn.py:165, 190): agreement to bf16 rounding (1e-2); for an f32
    cache its operands stay f32 (1e-5)."""
    from stable_ts_tpu.ops.self_attn import self_attn_decode as sa_jax
    q, k, v, ks, vs, anc = _beam_case(30 + pos, int8, g, pos)
    layer = 2
    ref = sa_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer, pos, H,
                 ks=jnp.asarray(ks[:, :, None]), vs=jnp.asarray(vs[:, :, None]),
                 anc=jnp.asarray(anc), q_per_kv=g, interpret=True)
    got = _port_beam(q, k, v, ks, vs, anc, layer, pos, g, int8)
    assert _rel_err(got, np.asarray(ref)) <= (1e-2 if int8 else 1e-5)


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a GPU is refused, not computed
    by the twin."""
    from stable_ts_tpu_torch.ops.dtw import dtw_cost
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention
    x = torch.empty((1, 4, D), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        flash_attention(x, x, x, H, 1.0)
    with pytest.raises(ValueError, match='unsupported device'):
        dtw_cost(torch.empty((1, 3, 5), device='meta'))
