"""Word localization in the port (``locate``) against stable_ts_tpu on the
CPU.

The tiny models are ``from_jax`` of JAX's ``load_test_model``, with the
alignment heads [(0, 1), (1, 0), (1, 1)] and with none. JAX runs as its own
tests run it on the CPU, with the cross-attention decode kernel in
interpret mode (STABLE_TS_TPU_CROSS=interpret), which rounds where the
port's does. Stated tolerances: probabilities within 1e-6; target ends,
tokens, words, starts and ends equal.

- ``locate`` in modes 2, 1 and 0, with known heads and with none, over
  40 s of noise (two 30-s chunks): the estimate alone, the confirmation
  decode that accepts every target token (``probability_threshold=0.0``,
  so that random weights confirm a match), one that never does (the
  default threshold), and one that accepts some tokens and rolls the
  decode back (a re-prefill), with an initial prompt, with exact tokens,
  with start and end;
- the port's own invariants, as JAX's tests pin them for JAX: the
  selective capture of every head equals the full capture
  (tests/test_aligner.py:265-283), a right-padded prefill then a step
  equal the teacher-forced pass (tests/test_whisper_model.py:91), and a
  step over the float self cache equals JAX's;
- the estimate's standard deviation over tokens (``correction=0``, as
  ``jnp.std``) against JAX's formula, with one token row and two: its
  z-scores within 1e-4, its frame equal."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)
SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]
# accepted at 1e-3 for its first two tokens, then rejected: the decode
# replaces the forced token and re-prefills (found by scanning this model)
ROLLBACK_TEXT = [199, 32, 199, 199]


@pytest.fixture(scope='module')
def known():
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    return jax_model, from_jax(jax_model, device='cpu')


@pytest.fixture(scope='module')
def no_heads():
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax()
    return jax_model, from_jax(jax_model, device='cpu')


@pytest.fixture(scope='module')
def audio():
    return (np.random.default_rng(5).standard_normal(SR * 40) * 0.3
            ).astype(np.float32)


@pytest.fixture
def jax_cross(monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')


def _matches(matches):
    """Matches as plain values: dicts (modes 2 and 1) as they are, with the
    words' probabilities split off; Segments (mode 0) as their words."""
    out, probs = [], []
    for m in matches:
        if isinstance(m, dict):
            m = dict(m)
            words = m.pop('duration_window_word', [])
            out.append((m, [(w['word'], list(w['tokens'])) for w in words]))
            probs += [w['probability'] for w in words]
        else:
            out.append([(w.word, w.start, w.end, list(w.tokens)) for w in m.words])
            probs += [w.probability for w in m.words]
    return out, probs


def _assert_same(got, ref):
    (g, gp), (r, rp) = _matches(got), _matches(ref)
    assert g == r
    assert gp == pytest.approx(rp, abs=1e-6)


CASES = {
    'estimate': dict(mode=2, count=2),
    'estimate, start and end': dict(mode=2, count=0, start=5.0, end=33.0),
    'confirm': dict(mode=1, count=2, probability_threshold=0.0),
    'confirm, no match': dict(mode=1, count=2),
    'confirm, rollback': dict(mode=1, count=2, text=ROLLBACK_TEXT,
                              probability_threshold=1e-3),
    'confirm, prompt': dict(mode=1, count=1, probability_threshold=0.0,
                            initial_prompt='hello there'),
    'confirm, exact tokens': dict(mode=1, count=1, exact_token=True,
                                  probability_threshold=0.0),
    'words': dict(mode=0, count=2, probability_threshold=0.0),
    'words, rollback': dict(mode=0, count=1, text=ROLLBACK_TEXT,
                            probability_threshold=1e-3),
}


@pytest.mark.parametrize('case', list(CASES))
def test_locate_matches_jax(known, audio, jax_cross, case):
    jax_model, port_model = known
    kw = dict(CASES[case])
    text = kw.pop('text', ' hello')
    kw.update(language='en', verbose=None)
    ref = jax_model.locate(audio, text, **kw)
    got = port_model.locate(audio, text, **kw)
    _assert_same(got, ref)
    if kw.get('probability_threshold') == 0.0:
        assert got, 'no match was confirmed'


@pytest.mark.parametrize('case', ['estimate', 'confirm', 'words'])
def test_locate_without_heads_matches_jax(no_heads, audio, jax_cross, case):
    """No known heads: the estimate reads every head's capture."""
    jax_model, port_model = no_heads
    kw = dict(CASES[case], language='en', verbose=None)
    _assert_same(port_model.locate(audio, ' hello', **kw),
                 jax_model.locate(audio, ' hello', **kw))


def test_rollback_re_prefills(known, audio, monkeypatch):
    """The rollback case really replaces decoded tokens: more prefills than
    the two chunks' first ones."""
    from stable_ts_tpu_torch.models.whisper import model as port_model_module
    prefills = []
    orig = port_model_module.decoder_prefill

    def counted(*a, **kw):
        prefills.append(kw.get('int8_cache'))
        return orig(*a, **kw)
    monkeypatch.setattr(port_model_module, 'decoder_prefill', counted)
    known[1].locate(audio, ROLLBACK_TEXT, language='en', mode=1, count=2,
                    probability_threshold=1e-3, verbose=None)
    assert len(prefills) > 2 and set(prefills) == {False}


# -- the port's own invariants -----------------------------------------------------------

def test_selective_capture_matches_full(known, no_heads, audio):
    """Every head selected through the capture table gives the estimate of
    the full capture (tests/test_aligner.py:265-283)."""
    from stable_ts_tpu_torch.loaders import WhisperTorch
    port_model = no_heads[1]
    all_heads = [(l, h) for l in range(port_model.dims.n_text_layer)
                 for h in range(port_model.dims.n_text_head)]
    selective = WhisperTorch(port_model.dims, port_model.params, device='cpu',
                             ranks=port_model._ranks, alignment_heads=all_heads)
    kw = dict(language='en', mode=2, count=2, verbose=None)
    full = port_model.locate(audio, ' hello', **kw)
    assert ([m['target_end'] for m in selective.locate(audio, ' hello', **kw)]
            == [m['target_end'] for m in full])


@pytest.mark.parametrize('int8_cache', [False, True])
def test_padded_prefill_then_step_matches_full(known, int8_cache):
    """A prefix prefilled with junk right-padding gives the teacher-forced
    logits at its last real position, and a step appending one token those
    of the next position: junk slots are never attended, and the step
    writes its own slot first (tests/test_whisper_model.py:91-129, at its
    tolerance). The step is checked on locate's float cache; the int8
    cache's rounding is the decode loops' (test_torch_model.py)."""
    from stable_ts_tpu_torch.models.whisper.model import (
        decoder_apply, decoder_prefill, decoder_step, encoder_apply,
        fuse_self_qkv, precompute_cross_kv_t)
    port_model = known[1]
    params = port_model.params
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 80, 3000)).astype(np.float32))
    seq, n, junk = [7, 11, 13, 17, 19, 23, 29], 5, 3
    with torch.inference_mode():
        xa = encoder_apply(params.encoder, mel)
        full, _ = decoder_apply(params.decoder, torch.tensor([seq]), xa)
        pre, cache = decoder_prefill(params.decoder,
                                     torch.tensor([seq[:n] + [junk] * 3]), xa, 16,
                                     int8_cache=int8_cache)
        np.testing.assert_allclose(pre[0, n - 1].numpy(), full[0, n - 1].numpy(),
                                   rtol=2e-4, atol=2e-4)
        assert ('ks' in cache) == int8_cache
        if int8_cache:
            return
        assert cache['k'].dtype == torch.float32 and cache['k'].shape[2] == 16
        step = decoder_step(params.decoder, torch.tensor([[seq[n]]]), n,
                            precompute_cross_kv_t(params.decoder, xa), cache,
                            fuse_self_qkv(params.decoder))
        np.testing.assert_allclose(step[0].numpy(), full[0, n].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_float_cache_step_matches_jax(known, jax_cross):
    """One decode step over the float self cache, against JAX's
    ``decoder_step`` over the cache its ``decoder_prefill`` keeps by
    default (locate's), with the cross K/V float in both."""
    import jax.numpy as jnp
    from stable_ts_tpu.models.whisper import model as jm
    from stable_ts_tpu_torch.models.whisper import model as pm
    jax_model, port_model = known
    dims = port_model.dims
    mel = np.random.default_rng(1).standard_normal((1, 80, 3000)).astype(np.float32)
    tokens = [1, 2, 3, 4]
    jp = jax_model.params
    xa_j = jm.encoder_apply(jp['encoder'], jnp.asarray(mel), dims.n_audio_head)
    _, cache_j = jm.decoder_prefill(jp['decoder'], jnp.asarray([tokens], jnp.int32),
                                    xa_j, dims.n_text_head, 32)
    dec_j = dict(jp['decoder'])
    dec_j['blocks'] = jm.fuse_self_qkv(dec_j['blocks'])
    ref, _ = jm.decoder_step(dec_j, jnp.asarray([[5]], jnp.int32), jnp.int32(4),
                             jm.precompute_cross_kv_t(jp['decoder'], xa_j),
                             cache_j, dims.n_text_head)
    with torch.inference_mode():
        dec = port_model.params.decoder
        xa = pm.encoder_apply(port_model.params.encoder, torch.from_numpy(mel))
        _, cache = pm.decoder_prefill(dec, torch.tensor([tokens]), xa, 32,
                                      int8_cache=False)
        got = pm.decoder_step(dec, torch.tensor([[5]]), 4,
                              pm.precompute_cross_kv_t(dec, xa), cache,
                              pm.fuse_self_qkv(dec))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# -- the estimate's normalization -------------------------------------------------------

def _jax_estimate_matrix(weights):
    """JAX's estimate after the capture (stable_ts_tpu/alignment.py:1085-1090)."""
    import jax
    import jax.numpy as jnp
    from stable_ts_tpu.ops.median import median_filter
    weights = jax.nn.softmax(jnp.asarray(weights).astype(jnp.float32), axis=-1)
    std = jnp.std(weights, axis=-2, keepdims=True)
    mean = jnp.mean(weights, axis=-2, keepdims=True)
    weights = median_filter((weights - mean) / jnp.where(std == 0, 1.0, std), 7)
    return np.asarray(weights.mean(axis=0))


@pytest.mark.parametrize('rows', [1, 2, 9])
def test_estimate_matrix_matches_jax(rows):
    """One token row (a zero deviation, which ``correction=1`` would turn
    into NaN) and two (where the two corrections differ by a factor of
    sqrt(2)). The z-scores are within 1e-4 (two f32 deviations of nearly
    equal values can differ in their last bits), the frame equal."""
    from stable_ts_tpu_torch.alignment import _estimate_matrix
    weights = (np.random.default_rng(rows).standard_normal((3, rows, 1500)) * 4
               ).astype(np.float32)
    ref = _jax_estimate_matrix(weights)
    got = _estimate_matrix(torch.from_numpy(weights)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert int(np.argmax(got[-1])) == int(np.argmax(ref[-1]))

