"""The port's quantized path against stable_ts_tpu on the CPU, with inputs
from a numpy seed: weight and activation quantization (values and scales
exactly equal), the weight-only matmul twin vs ``int8_matmul`` (Pallas,
STABLE_TS_TPU_WOQ=interpret), the packed-int4 cross-attention twin vs
``cross_attn_decode(bits=4)`` (STABLE_TS_TPU_CROSS=interpret), the int4
cross K/V vs ``precompute_cross_kv_t(quantize=4)`` unpacked, the vocab
projection twin vs ``vocab_logits_kernel`` (STABLE_TS_TPU_VOCAB=interpret),
and ``from_jax`` of a ``dq`` model."""
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


@pytest.mark.parametrize('shape', [(96, 160), (3, 64, 256)], ids=['2d', 'stacked'])
def test_quantize_weight_matches_jax(shape):
    from stable_ts_tpu.models.whisper.quantization import quantize_weight as qw_jax
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_weight
    rng = np.random.default_rng(30)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)   # (..., in, out)
    w[..., 5] = 0.0                                              # a zero channel
    ref = qw_jax(jnp.asarray(w))
    q, scale = quantize_weight(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    # JAX keeps (..., in, out) and (..., 1, out); the port (..., out, in), (..., out)
    np.testing.assert_array_equal(np.swapaxes(q.numpy(), -1, -2), np.asarray(ref.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref.scale)[..., 0, :])
    assert scale.numpy()[..., 5].min() == 1.0


@pytest.mark.parametrize('bits', [4, 8])
@pytest.mark.parametrize('axis', [-1, 1])
def test_quantize_tensor_matches_jax(bits, axis):
    from stable_ts_tpu.models.whisper.quantization import quantize_tensor as qt_jax
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_tensor
    rng = np.random.default_rng(31 + bits)
    x = rng.standard_normal((3, 50, 64)).astype(np.float32)
    x[1, 7] = 0.0
    ref = qt_jax(jnp.asarray(x), reduce_axis=axis, bits=bits)
    q, scale = quantize_tensor(torch.from_numpy(x), reduce_axis=axis, bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref.scale))
    assert np.abs(q.numpy()).max() == 2 ** (bits - 1) - 1


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('m,k,n', [(1, 64, 192), (7, 80, 100), (37, 96, 33),
                                   (300, 64, 256), (16, 112, 65), (17, 112, 130),
                                   (64, 112, 65), (65, 112, 130), (257, 112, 65)])
def test_woq_twin_matches_pallas_interpret(m, k, n, dtype, monkeypatch):
    """Ragged M, K and N; the Pallas kernel pads M and N to its tiles. The
    later cases sit on the CUDA kernel's tile edges: x tiles of 16, 64 and
    256 rows either side, output columns ragged over 64-column tiles, K = 7
    steps of 16 (a ragged 64-wide K slab)."""
    monkeypatch.setenv('STABLE_TS_TPU_WOQ', 'interpret')
    from stable_ts_tpu.models.whisper.quantization import quantize_weight as qw_jax
    from stable_ts_tpu.ops.woq_matmul import int8_matmul
    from stable_ts_tpu_torch.ops.woq_matmul import woq_matmul
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qa = qw_jax(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    xj = jnp.asarray(x, dtype)
    ref = np.asarray(int8_matmul(xj, qa.q, qa.scale), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    q_t = torch.from_numpy(np.asarray(qa.q).T.copy())
    s_t = torch.from_numpy(np.asarray(qa.scale)[0].copy())
    got = woq_matmul(xt, q_t, s_t)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    # f32 accumulation of the same exact products, in another order; the
    # wrapper casts to x's dtype as stable_ts_tpu's linear does
    bias = rng.standard_normal(n).astype(np.float32)
    got_b = woq_matmul(xt, q_t, s_t, torch.from_numpy(bias))
    # f32 output: 1e-5; bf16 output: its rounding, 2^-8 relative
    tol = 1e-5 if dtype == 'float32' else 2 ** -8
    assert _rel_err(got.float().numpy(), ref) <= tol
    assert _rel_err(got_b.float().numpy(), ref + bias) <= tol


def _split_half_pack(q):
    """JAX's int4 tile layout: (..., S, d) int8 on the int4 grid -> the
    transposed (..., d/2, S) bytes with dim r low, dim r + d/2 high."""
    t = np.swapaxes(q, -1, -2).astype(np.int32)
    d = t.shape[-2]
    lo, hi = t[..., :d // 2, :], t[..., d // 2:, :]
    byte = ((hi & 0xF) << 4) | (lo & 0xF)
    return np.where(byte > 127, byte - 256, byte).astype(np.int8)


def _quantize_int4(x):
    amax = np.abs(x).max(-1, keepdims=True)
    sc = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / sc), -7, 7).astype(np.int8), sc[..., 0]


@pytest.mark.parametrize('g', [1, 5])
@pytest.mark.parametrize('s', [100, 700])
def test_int4_cross_twin_matches_pallas_interpret(g, s, monkeypatch):
    """bits=4, one and five query rows per window: the same values and
    scales in the two packings."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    from stable_ts_tpu.ops.cross_attn import cross_attn_decode as ca_jax
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode, pack_int4
    rng = np.random.default_rng(40 + g + s)
    layers, windows, layer = 2, 2, 1
    q4, sc = _quantize_int4(rng.standard_normal((layers, windows, 2, s, D))
                            .astype(np.float32))
    q = (rng.standard_normal((windows * g, D)) * DH ** -0.5).astype(np.float32)
    s_pad = (s + 511) // 512 * 512
    kvt4 = np.zeros((layers, windows, 2, D // 2, s_pad), np.int8)
    kvt4[..., :s] = _split_half_pack(q4)
    sct = np.ones((layers, windows, 2, 1, s_pad), np.float32)
    sct[:, :, :, 0, :s] = sc
    ref = ca_jax(jnp.asarray(q), jnp.asarray(kvt4), jnp.asarray(sct), H, s=s,
                 q_per_kv=g, layer_idx=layer, bits=4)
    packed = pack_int4(torch.from_numpy(q4))
    assert packed.shape == (layers, windows, 2, s, D // 2)
    got = cross_attn_decode(torch.from_numpy(q), packed, torch.from_numpy(sc),
                            layer, s, H, q_per_kv=g, bits=4)
    # the int8 entries' tolerance: the same bf16 rounding points
    assert _rel_err(got.numpy(), ref) <= 1e-4
    # the same as the int8 entry fed the unpacked values
    unpacked = cross_attn_decode(torch.from_numpy(q), torch.from_numpy(q4),
                                 torch.from_numpy(sc), layer, s, H, q_per_kv=g)
    assert torch.equal(got, unpacked)


def test_int4_packing_round_trips_and_is_checked():
    from stable_ts_tpu_torch.ops.cross_attn import (cross_attn_decode, pack_int4,
                                                    unpack_int4)
    vals = torch.arange(-8, 8, dtype=torch.int8)
    grid = torch.cartesian_prod(vals, vals).to(torch.int8)       # (256, 2)
    packed = pack_int4(grid)
    assert packed.shape == (256, 1) and len(set(packed[:, 0].tolist())) == 256
    assert torch.equal(unpack_int4(packed), grid)
    q = torch.zeros((1, D))
    kv = torch.zeros((1, 1, 2, 10, D), dtype=torch.int8)
    sc = torch.ones((1, 1, 2, 10))
    with pytest.raises(ValueError, match='bits=4'):
        cross_attn_decode(q, kv, sc, 0, 10, H, bits=4)
    with pytest.raises(ValueError, match='bits=4'):
        cross_attn_decode(q, kv[..., :D // 2].float(), sc, 0, 10, H, bits=4)
    with pytest.raises(ValueError, match='bits=4'):
        cross_attn_decode(torch.zeros((1, D + 1)), kv[..., :D // 2], sc, 0, 10, H,
                          bits=4)
    with pytest.raises(ValueError, match='width'):
        cross_attn_decode(q, kv[..., :D // 2], sc, 0, 10, H)


def test_int4_cross_kv_matches_jax_unpacked():
    """precompute_cross_kv_t(quantize=4) on both: integer weights and
    features keep the projections exact in f32, so the int4 values and
    the scales must be equal, once unpacked from either packing."""
    from stable_ts_tpu.models.whisper import model as jm
    from stable_ts_tpu_torch.models.whisper import model as pm
    from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    from stable_ts_tpu_torch.ops.cross_attn import unpack_int4
    rng = np.random.default_rng(50)
    params = jm.init_params(jm.tiny_test_dims(), seed=3)
    ca = params['decoder']['blocks']['cross_attn']
    for proj in ('k', 'v'):
        ca[proj] = dict(ca[proj], w=jnp.asarray(
            rng.integers(-3, 4, ca[proj]['w'].shape).astype(np.float32)))
    model = from_jax_params(params, tiny_test_dims(), device='cpu')
    s = 300
    xa = rng.integers(-4, 5, (2, s, D)).astype(np.float32)
    xa[0, 11] = 0.0                     # a zero row: scale 1
    ref = jm.precompute_cross_kv_t(params['decoder'], jnp.asarray(xa), quantize=4)
    got = pm.precompute_cross_kv_t(model.decoder, torch.from_numpy(xa), quantize=4)
    b = np.asarray(ref['kvT4']).astype(np.int32)          # (L, B, 2, d/2, S_pad)
    lo, hi = ((b & 0xF) ^ 8) - 8, b >> 4
    ref_vals = np.swapaxes(np.concatenate([lo, hi], axis=-2), -1, -2)[..., :s, :]
    assert got['bits'] == 4 and got['kv'].shape[-1] == D // 2
    np.testing.assert_array_equal(unpack_int4(got['kv']).numpy(), ref_vals)
    np.testing.assert_array_equal(got['sc'].numpy(),
                                  np.asarray(ref['sc'])[:, :, :, 0, :s])
    assert np.abs(ref_vals).max() == 7 and int(ref['s']) == got['s'] == s


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('m,k,v', [(16, 64, 1031), (1, 128, 2048), (5, 64, 4100)])
def test_vocab_twin_matches_pallas_interpret(m, k, v, dtype, monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_VOCAB', 'interpret')
    from stable_ts_tpu.ops.vocab_proj import vocab_logits_kernel
    from stable_ts_tpu_torch.ops.vocab_proj import vocab_proj
    rng = np.random.default_rng(m + k + v)
    x = jnp.asarray(rng.standard_normal((m, k)), dtype)
    emb = jnp.asarray(rng.standard_normal((v, k)) * 0.05, dtype)
    ref = np.asarray(vocab_logits_kernel(x, emb, block_v=512))

    def to_t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))

    got = vocab_proj(to_t(x), to_t(emb))
    assert got.dtype == torch.float32 and got.shape == (m, v)
    # f32 sums of the same exact products, in another order
    assert _rel_err(got.numpy(), ref) <= 1e-5


def test_vocab_logits_routes_decode_shapes():
    """TextDecoder.vocab_logits sends 2-D x of at most 256 rows against a
    vocabulary of at least 2048 to the vocab projection, other shapes to
    the f32 product; both give the same logits."""
    from unittest import mock
    from stable_ts_tpu_torch.models.whisper import model as pm
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    import dataclasses
    dims = dataclasses.replace(tiny_test_dims(), n_vocab=4096, n_text_layer=1,
                               n_audio_layer=1)
    dec = pm.init_params(dims, seed=2, dtype=torch.bfloat16, device='cpu').decoder
    x = torch.randn((5, D), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    with mock.patch.object(pm, 'vocab_proj', wraps=pm.vocab_proj) as spy:
        step = dec.vocab_logits(x)
        full = dec.vocab_logits(x[None])[0]
        assert spy.call_count == 1
    assert torch.equal(step, full)


def test_from_jax_dq_weights_exact():
    """Every int8 weight and scale of a dq WhisperTPU carries over exactly,
    and quantizing the port's float copy gives the same values."""
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu.models.whisper.quantization import quantized_bytes as qb_jax
    from stable_ts_tpu_torch.loaders import WhisperTorch, from_jax
    from stable_ts_tpu_torch.models.whisper.quantization import (
        LINEAR_KEYS, QuantizedLinear, quantized_bytes)
    jax_dq = load_jax(seed=4, dq=True)
    port = from_jax(jax_dq, device='cpu')
    assert port.quantized
    port_q = WhisperTorch(port.dims, from_jax(load_jax(seed=4), device='cpu').params,
                          device='cpu', dq=True)
    checked = 0
    for stack in ('encoder', 'decoder'):
        jblocks = jax_dq.params[stack]['blocks']
        for layer, blk in enumerate(getattr(port.params, stack).blocks):
            for attn in ('attn', 'cross_attn', 'mlp'):
                if attn not in jblocks:
                    continue
                for proj in LINEAR_KEYS:
                    if proj not in jblocks[attn]:
                        continue
                    w = jblocks[attn][proj]['w']
                    lin = getattr(getattr(blk, attn), proj)
                    assert isinstance(lin, QuantizedLinear) and lin.weight.dtype == torch.int8
                    np.testing.assert_array_equal(lin.weight.numpy(),
                                                  np.asarray(w.q)[layer].T)
                    np.testing.assert_array_equal(lin.scale.numpy(),
                                                  np.asarray(w.scale)[layer, 0])
                    twin = getattr(getattr(getattr(port_q.params, stack).blocks[layer],
                                           attn), proj)
                    assert torch.equal(twin.weight, lin.weight)
                    assert torch.equal(twin.scale, lin.scale)
                    checked += 1
    assert checked == 2 * 6 + 2 * 10    # 2 encoder and 2 decoder layers
    assert quantized_bytes(port.params) == qb_jax(jax_dq.params)
    assert not isinstance(port.params.encoder.conv1, QuantizedLinear)
    assert port.params.decoder.token_emb.dtype == torch.float32


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dequantize_params_matches_jax(dtype):
    """dequantize_params gives plain linears holding q * scale with both
    cast to the compute dtype first, as QuantizedArray.dequantize: equal
    weights, in torch's (out, in) layout."""
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu.models.whisper.quantization import (
        dequantize_params as dq_jax, quantize_params as qp_jax)
    from stable_ts_tpu_torch.loaders import from_jax
    from stable_ts_tpu_torch.models.whisper.quantization import (
        QuantizedLinear, dequantize_params)
    jax_float = load_jax(seed=5)
    ref = dq_jax(qp_jax(jax_float.params, compute_dtype=getattr(jnp, dtype)))
    port = from_jax(load_jax(seed=5, dq=True), device='cpu').params
    dequantize_params(port, getattr(torch, dtype))
    for layer, blk in enumerate(port.decoder.blocks):
        for attn in ('attn', 'cross_attn', 'mlp'):
            for proj in ('q', 'k', 'v', 'out', 'fc1', 'fc2'):
                lin = getattr(getattr(blk, attn), proj, None)
                if lin is None:
                    continue
                assert isinstance(lin, torch.nn.Linear) and not isinstance(
                    lin, QuantizedLinear)
                w = ref['decoder']['blocks'][attn][proj]['w'][layer]
                np.testing.assert_array_equal(
                    lin.weight.float().numpy(),
                    np.asarray(w.astype(jnp.float32)).T)


# -- the dyn recipe: int8 activations x int8 weights (STABLE_TS_TPU_WOQ=dyn) ----------------

@pytest.fixture
def jax_dyn(monkeypatch):
    """JAX's linear under STABLE_TS_TPU_WOQ=dyn. JAX reads the switch when
    it traces, so its caches are cleared on the way in (no trace of another
    mode is reused) and on the way out (no dyn trace outlives the test)."""
    import jax
    monkeypatch.setenv('STABLE_TS_TPU_WOQ', 'dyn')
    jax.clear_caches()
    yield
    jax.clear_caches()


def _jax_dyn_codes(x, q):
    """The codes, row scales and int32 sums of stable_ts_tpu's dyn branch
    (models/whisper/model.py:93-99), compiled as the model compiles them."""
    import jax

    @jax.jit
    def steps(x, q):
        x32 = x.astype(jnp.float32)
        amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
        xs = jnp.where(amax > 0, amax / 127.0, 1.0)
        xq = jnp.clip(jnp.round(x32 / xs), -127, 127).astype(jnp.int8)
        return xq, xs, jax.lax.dot_general(xq, q, (((1,), (0,)), ((), ())),
                                           preferred_element_type=jnp.int32)
    return [np.asarray(a) for a in steps(x, q)]


def _check_dyn_against_jax(x, q_t, scale_t, bias_t, qa, b_jax):
    """The port's codes, scales and int32 sums equal JAX's; its output is
    within 1e-6 of JAX's compiled linear relative to the largest value (XLA
    contracts the scale and bias into one fused multiply-add, the port
    rounds twice). x: (M, K) torch tensor."""
    import jax
    from stable_ts_tpu.models.whisper.model import linear
    from stable_ts_tpu_torch.models.whisper.quantization import (dyn_linear, int8_mm,
                                                                 quantize_rows)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16
                                               else jnp.float32)
    ref_q, ref_s, ref_y = _jax_dyn_codes(xj, qa.q)
    xq, xs = quantize_rows(x)
    np.testing.assert_array_equal(xq.numpy(), ref_q)
    np.testing.assert_array_equal(xs.numpy(), ref_s[:, 0])
    np.testing.assert_array_equal(int8_mm(xq, q_t).numpy(), ref_y)
    got = dyn_linear(x, q_t, scale_t, bias_t)
    ref = np.asarray(jax.jit(linear)(xj, qa, b_jax).astype(jnp.float32))
    assert got.dtype == x.dtype
    assert _rel_err(got.float().numpy(), ref) <= 1e-6


@pytest.mark.parametrize('bias', [False, True], ids=['no_bias', 'bias'])
@pytest.mark.parametrize('m', [1, 5, 64])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dyn_matches_jax_linear(dtype, m, bias, jax_dyn):
    from stable_ts_tpu.models.whisper.quantization import quantize_weight as qw_jax
    rng = np.random.default_rng(50 + m + 7 * bias)
    k, n = 96, 80
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[m // 2] = 0.0 if m > 1 else x[0]          # a zero row: scale 1, codes 0
    qa = qw_jax(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q_t = torch.from_numpy(np.asarray(qa.q).T.copy())
    s_t = torch.from_numpy(np.asarray(qa.scale)[0].copy())
    _check_dyn_against_jax(xt, q_t, s_t, None if b is None else torch.from_numpy(b), qa,
                           None if b is None else jnp.asarray(b))


def test_dyn_selects_the_recipe_and_nothing_else(monkeypatch):
    """JAX's switch values select dyn; any other keeps the weight-only
    product (its CPU twin here)."""
    from stable_ts_tpu_torch.models.whisper import quantization
    from stable_ts_tpu_torch.ops import woq_matmul
    lin = quantization.QuantizedLinear.from_linear(torch.nn.Linear(64, 48))
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    for value in ('dyn', '1', 'on', 'true'):
        monkeypatch.setenv('STABLE_TS_TPU_WOQ', value)
        assert torch.equal(lin(x), quantization.dyn_linear(x, lin.weight, lin.scale,
                                                           lin.bias))
    for value in ('auto', 'pallas', 'interpret', 'astype', '0', 'off'):
        monkeypatch.setenv('STABLE_TS_TPU_WOQ', value)
        assert torch.equal(lin(x), woq_matmul.woq_matmul(x, lin.weight, lin.scale,
                                                         lin.bias))
    monkeypatch.delenv('STABLE_TS_TPU_WOQ')
    assert quantization._woq_mode() == 'woq'


def test_dyn_rows_go_unpadded_on_the_cpu():
    """The CUDA product takes more than 16 rows: int8_mm pads fewer with
    zero rows and slices them off; on the CPU the rows go as they are."""
    from stable_ts_tpu_torch.models.whisper import quantization
    calls = []
    real = torch._int_mm
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (3, 32)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 32)).astype(np.int8))
    try:
        torch._int_mm = lambda a, b: calls.append(a.shape) or real(a, b)
        got = quantization.int8_mm(xq, w)
    finally:
        torch._int_mm = real
    assert calls == [(3, 32)] and quantization.INT_MM_MIN_ROWS == 17
    np.testing.assert_array_equal(got.numpy(), xq.int().numpy() @ w.int().numpy().T)


def _dyn_model_pair():
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=[(0, 1), (1, 0), (1, 1)], dq=True)
    return jax_model, from_jax(jax_model, device='cpu')


def _noise(seconds, seed=21):
    return (np.random.default_rng(seed).standard_normal(16000 * seconds)
            * 0.1).astype(np.float32)


def test_dyn_linears_match_jax_inside_the_model(jax_dyn, monkeypatch):
    """Every quantized linear of the tiny dq model on the activations a dyn
    transcribe gives it (the encoder, the prefill, the decode steps, the
    timing pass): the port's codes and int32 sums equal JAX's, its output
    within 1e-6 of JAX's compiled linear."""
    from stable_ts_tpu.models.whisper.quantization import QuantizedArray
    from stable_ts_tpu_torch.models.whisper.quantization import QuantizedLinear
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    _, port_model = _dyn_model_pair()
    seen = {}   # (module name, more than one row): (module, its first such input)

    def keep(name):
        def hook(mod, args):
            x = args[0]
            seen.setdefault((name, x.shape[:-1].numel() > 1), (mod, x.detach().clone()))
        return hook
    hooks = [mod.register_forward_pre_hook(keep(name))
             for name, mod in port_model.params.named_modules()
             if isinstance(mod, QuantizedLinear)]
    try:
        port_model.transcribe(_noise(8), language='en', temperature=0, verbose=None,
                              kv_quant=4)
    finally:
        for h in hooks:
            h.remove()
    assert len({name for name, _ in seen}) == 2 * 6 + 2 * 10   # every linear ran
    for mod, x in seen.values():
        qa = QuantizedArray(jnp.asarray(mod.weight.numpy().T.copy()),
                            jnp.asarray(mod.scale.numpy()[None]), jnp.float32)
        b = None if mod.bias is None else mod.bias.detach()
        _check_dyn_against_jax(x.reshape(-1, x.shape[-1]), mod.weight, mod.scale, b, qa,
                               None if b is None else jnp.asarray(b.numpy()))


def test_dyn_transcribe_matches_jax(jax_dyn, monkeypatch):
    """A dq transcribe under dyn (packed int4 cross K/V, greedy, known
    heads) on the 20 s of noise the option cases of test_torch_slice.py
    use: JAX's tokens and word-level SRT bytes."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')
    jax_model, port_model = _dyn_model_pair()
    audio = _noise(20)
    kw = dict(language='en', temperature=0, verbose=None, kv_quant=4)
    ref = jax_model.transcribe(audio, **kw)
    got = port_model.transcribe(audio, **kw)
    assert [s.tokens for s in got.segments] == [s.tokens for s in ref.segments]
    assert len(ref.segments) > 1
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)


def test_dyn_moves_with_the_last_bit_of_the_input(jax_dyn, monkeypatch):
    """Why the dyn comparisons of whole requests stop at the cases above:
    scaling 40 s of noise by (1 + 2^-23) changes the word-level SRT of a
    dyn transcribe in JAX and in the port alike. An activation one bit off
    can cross a rounding edge of its int8 code, and the frameworks' float
    arithmetic differs in the last bit (XLA contracts multiply-adds into
    FMAs and sums in another order), so the port cannot follow JAX's dyn
    further than JAX follows itself."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')
    jax_model, port_model = _dyn_model_pair()
    audio = _noise(40)
    nudged = audio * np.float32(1 + 2 ** -23)
    assert not np.array_equal(audio, nudged)
    kw = dict(language='en', temperature=0, verbose=None, kv_quant=4)
    for model in (jax_model, port_model):
        a, b = (model.transcribe(clip, **kw).to_srt_vtt(word_level=True)
                for clip in (audio, nudged))
        assert a != b, type(model).__name__
