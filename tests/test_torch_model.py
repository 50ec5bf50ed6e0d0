"""The port's Whisper model against stable_ts_tpu's on the CPU, with the
same weights (converted by ``from_jax_params``) and the same seeded inputs:
the encoder, the teacher-forced decoder with selective QK capture, the
prefill into the int8 row cache and 20 chained decode steps. Tiny dims, f32.

Tolerances: f32 tensors within 1e-4 of each tensor's max-abs (the two
frameworks sum in different orders, and the port's flash / decode twins
scale the scores once where JAX scales q and k separately)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_ts_tpu.models.whisper import model as jm
from stable_ts_tpu_torch.models.whisper import model as pm
from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims

torch.set_num_threads(2)
TOL = 1e-4


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope='module')
def pair():
    dims = tiny_test_dims()
    params = jm.init_params(jm.tiny_test_dims(), seed=3)
    return dims, params, from_jax_params(params, dims, device='cpu')


@pytest.fixture(scope='module')
def xa(pair):
    """Encoder features of one seeded mel through the JAX encoder."""
    _, params, _ = pair
    mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32)
    return np.asarray(jm.encoder_apply(params['encoder'], jnp.asarray(mel), 2))


def test_from_jax_params_layout(pair):
    dims, params, model = pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    enc, dec = params['encoder'], params['decoder']
    np.testing.assert_array_equal(sd['encoder.conv1.weight'],
                                  np.asarray(enc['conv1']['w']).transpose(2, 1, 0))
    np.testing.assert_array_equal(sd['decoder.blocks.1.cross_attn.q.weight'],
                                  np.asarray(dec['blocks']['cross_attn']['q']['w'])[1].T)
    np.testing.assert_array_equal(sd['encoder.blocks.0.mlp.fc2.bias'],
                                  np.asarray(enc['blocks']['mlp']['fc2']['b'])[0])
    np.testing.assert_array_equal(sd['decoder.token_emb'], np.asarray(dec['token_emb']))
    n_jax = sum(np.asarray(x).size for x in __import__('jax').tree.leaves(params))
    assert sum(v.size for v in sd.values()) == n_jax


def test_init_params_shapes_and_statistics():
    dims = tiny_test_dims()
    a = pm.init_params(dims, seed=1, device='cpu')
    b = pm.init_params(dims, seed=1, device='cpu')
    c = pm.init_params(dims, seed=2, device='cpu')
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.decoder.token_emb, c.decoder.token_emb)
    jax_params = jm.init_params(jm.tiny_test_dims(), seed=1)
    converted = from_jax_params(jax_params, dims, device='cpu').state_dict()
    for name, p in a.state_dict().items():
        assert p.shape == converted[name].shape, name
    w = a.decoder.blocks[0].mlp.fc1.weight
    assert abs(w.std().item() - dims.n_text_state ** -0.5) < 0.01
    assert torch.equal(a.encoder.ln_post.weight, torch.ones(dims.n_audio_state))


def test_encoder_matches_jax(pair, xa):
    _, params, model = pair
    mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32)
    got = pm.encoder_apply(model.encoder, torch.from_numpy(mel))
    assert got.shape == xa.shape
    assert _rel_err(got.numpy(), xa) <= TOL


@pytest.mark.parametrize('heads', [[(0, 1), (1, 0), (1, 1)], None],
                         ids=['selected', 'all'])
def test_decoder_apply_capture_matches_jax(pair, xa, heads):
    from stable_ts_tpu.models.whisper.timing import build_head_capture_table
    _, params, model = pair
    tokens = np.random.default_rng(1).integers(0, 1800, (1, 23))
    index = (None if heads is None
             else np.asarray(build_head_capture_table(heads, 2)[0]))
    ref_logits, ref_qk = jm.decoder_apply(
        params['decoder'], jnp.asarray(tokens, jnp.int32), jnp.asarray(xa), 2,
        capture_qk=True, capture_index=None if index is None else jnp.asarray(index))
    logits, qk = pm.decoder_apply(model.decoder, torch.from_numpy(tokens),
                                  torch.from_numpy(xa.copy()), capture_qk=True,
                                  capture_index=index)
    assert _rel_err(logits.numpy(), ref_logits) <= TOL
    assert qk.dtype == torch.bfloat16 and tuple(qk.shape) == ref_qk.shape
    # the captured QK is stored bf16: equal after the cast, except where the
    # f32 values straddle a bf16 rounding boundary (then one bf16 step)
    got = qk.float().numpy()
    ref = np.asarray(ref_qk.astype(jnp.float32))
    same = got == ref
    assert same.mean() >= 0.999, same.mean()
    bound = 2 ** -7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-6 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound)


def test_decoder_prefill_int8_cache_matches_jax(pair, xa):
    _, params, model = pair
    tokens = np.array([[1, 2, 3, 5, 8, 13, 21]])
    ref_logits, ref_cache = jm.decoder_prefill(
        params['decoder'], jnp.asarray(tokens, jnp.int32), jnp.asarray(xa), 2,
        128, int8_cache=True)
    logits, cache = pm.decoder_prefill(model.decoder, torch.from_numpy(tokens),
                                       torch.from_numpy(xa.copy()), 128)
    assert _rel_err(logits.numpy(), ref_logits) <= TOL
    for name in ('k', 'v'):
        q_ref = np.asarray(ref_cache[name])
        s_ref = np.asarray(ref_cache[name + 's'])[:, :, 0]
        assert cache[name].dtype == torch.int8
        # int8 codes: equal but where an f32 ulp moves a value across a .5
        assert np.abs(cache[name].numpy().astype(int) - q_ref).max() <= 1
        assert (cache[name].numpy() == q_ref).mean() >= 0.999
        np.testing.assert_allclose(cache[name + 's'].numpy(), s_ref, rtol=1e-5)


def test_twenty_decoder_steps_match_jax(pair, xa, monkeypatch):
    """Chained steps over the int8 self cache and int8 cross K/V: JAX runs
    its XLA cache path and the cross kernel in interpret mode."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    _, params, model = pair
    dec_jax = dict(params['decoder'])
    dec_jax['blocks'] = jm.fuse_self_qkv(dec_jax['blocks'])
    prompt = np.array([[1, 2, 3]])
    _, cache_j = jm.decoder_prefill(params['decoder'], jnp.asarray(prompt, jnp.int32),
                                    jnp.asarray(xa), 2, 128, int8_cache=True)
    cross_j = jm.precompute_cross_kv_t(params['decoder'], jnp.asarray(xa),
                                       quantize=True)
    _, cache_p = pm.decoder_prefill(model.decoder, torch.from_numpy(prompt),
                                    torch.from_numpy(xa.copy()), 128)
    cross_p = pm.precompute_cross_kv_t(model.decoder, torch.from_numpy(xa.copy()),
                                       quantize=True)
    kv_ref = np.asarray(cross_j['kvT'])[..., :xa.shape[1]].transpose(0, 1, 2, 4, 3)
    assert np.abs(cross_p['kv'].numpy().astype(int) - kv_ref).max() <= 1
    fused = pm.fuse_self_qkv(model.decoder)
    tok = 7
    for step in range(20):
        pos = 3 + step
        ref, cache_j = jm.decoder_step(dec_jax, jnp.asarray([[tok]], jnp.int32),
                                       jnp.int32(pos), cross_j, cache_j, 2)
        got = pm.decoder_step(model.decoder, torch.tensor([[tok]]), pos,
                              cross_p, cache_p, fused)
        ref = np.asarray(ref)
        assert _rel_err(got.numpy(), ref) <= TOL, step
        tok = int(ref.argmax())
        assert int(got.argmax()) == tok, step
