"""The port's decoding strategies against stable_ts_tpu on the CPU, with the
same weights (``from_jax``) and seeded inputs: language detection on a tiny
multilingual model, beam search token for token through ``transcribe``, the
best_of candidate rule, the sampler's distribution and seeding, and the
temperature ladder's rungs. The decoder step of best_of groups and beams
(``q_per_kv``, ``anc``) is held against JAX's ``decoder_step``.

JAX runs as its own tests do off the TPU: the cross-attention decode kernel
in interpret mode (STABLE_TS_TPU_CROSS=interpret) and the int8 self cache
(STABLE_TS_TPU_SELFKV=1) through its XLA path. JAX's PRNG cannot be
matched, so sampling is held by its structure, not its draws."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)
HEADS = [(0, 1), (1, 0), (1, 1)]


def _audio(seconds=12, seed=21):
    return (np.random.default_rng(seed).standard_normal(16000 * seconds)
            * 0.1).astype(np.float32)


def _rank_table(n=50257):
    """A synthetic byte-level rank table the size of the multilingual
    vocabulary's (special tokens follow it, so ids line up with Whisper)."""
    ranks = {bytes([b]): b for b in range(256)}
    i = 256
    while len(ranks) < n:
        ranks[b'\x00' + i.to_bytes(3, 'big')] = i
        i += 1
    return ranks


@pytest.fixture
def jax_knobs(monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')


@pytest.fixture(scope='module')
def tiny_pair():
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    return jax_model, from_jax(jax_model, device='cpu')


@pytest.fixture(scope='module')
def multilingual_pair():
    from stable_ts_tpu.loaders import WhisperTPU
    from stable_ts_tpu.models.whisper.model import init_params, tiny_test_dims
    from stable_ts_tpu_torch.loaders import from_jax
    dims = dataclasses.replace(tiny_test_dims(), n_vocab=51865)
    jax_model = WhisperTPU(dims, init_params(dims, seed=5), name='tiny-multi',
                           ranks=_rank_table(), alignment_heads=HEADS)
    return jax_model, from_jax(jax_model, device='cpu')


def test_detect_language_matches_jax(multilingual_pair):
    jax_model, port_model = multilingual_pair
    mel = np.random.default_rng(3).standard_normal((3, 80, 3000)).astype(np.float32)
    codes_ref, probs_ref = jax_model.detect_language(jnp.asarray(mel))
    codes, probs = port_model.detect_language(torch.from_numpy(mel))
    assert codes == codes_ref
    for got, ref in zip(probs, probs_ref):
        assert got.keys() == ref.keys()
        np.testing.assert_allclose([got[c] for c in ref], list(ref.values()),
                                   rtol=1e-5, atol=1e-7)


def test_decode_without_language_detects_it(multilingual_pair):
    _, port_model = multilingual_pair
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (80, 3000)).astype(np.float32))
    (code,), _ = port_model.detect_language(mel)
    (result,) = port_model.decode(mel, sample_len=4)
    assert result.language == code


@pytest.mark.parametrize('patience', [None, 2.0], ids=['patience_none', 'patience_2'])
@pytest.mark.parametrize('beam_size', [2, 5])
def test_beam_transcribe_matches_jax(tiny_pair, jax_knobs, beam_size, patience):
    jax_model, port_model = tiny_pair
    audio = _audio()
    kw = dict(language='en', temperature=0, beam_size=beam_size,
              patience=patience, verbose=None)
    ref = jax_model.transcribe(audio, **kw)
    got = port_model.transcribe(audio, **kw)
    assert [s.tokens for s in got.segments] == [s.tokens for s in ref.segments]
    assert len(got.segments) > 0
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)


@pytest.mark.parametrize('eot_bias,beam_size,patience', [
    (0.0, 2, None), (0.105, 3, None), (0.11, 3, 2.0), (0.11, 2, None)])
def test_beam_decode_matches_jax(jax_knobs, eot_bias, beam_size, patience):
    """decode() on three windows. A bias towards EOT (the final layer
    norm's bias and EOT's embedding row along one axis) makes windows
    finish at different steps, so the candidate pool, frozen windows and
    the live-beam fallback all run."""
    from stable_ts_tpu.loaders import WhisperTPU
    from stable_ts_tpu.models.whisper.model import init_params, tiny_test_dims
    from stable_ts_tpu.models.whisper.tokenizer import synthetic_byte_ranks
    from stable_ts_tpu_torch.loaders import from_jax
    dims = tiny_test_dims()
    params = init_params(dims, seed=0)
    dec = params['decoder']
    axis = np.eye(dims.n_text_state, dtype=np.float32)[0]
    dec['ln'] = dict(dec['ln'], b=jnp.asarray(axis * 4.0))
    jax_model = WhisperTPU(dims, params, ranks=synthetic_byte_ranks())
    eot = jax_model.get_tokenizer('en', 'transcribe').eot
    dec['token_emb'] = dec['token_emb'].at[eot].set(jnp.asarray(axis * eot_bias))
    jax_model = WhisperTPU(dims, params, ranks=synthetic_byte_ranks())
    port_model = from_jax(jax_model, device='cpu')
    mel = np.random.default_rng(5).standard_normal((3, 80, 3000)).astype(np.float32)
    mel[1] *= 0.0
    mel[2] *= 3.0
    kw = dict(language='en', temperature=0, beam_size=beam_size, patience=patience)
    ref = jax_model.decode(jnp.asarray(mel), **kw)
    got = port_model.decode(torch.from_numpy(mel), **kw)
    for a, b in zip(got, ref):
        assert a.tokens == b.tokens
        assert a.avg_logprob == pytest.approx(b.avg_logprob, rel=1e-5)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, rel=1e-5)
    if eot_bias:
        assert min(len(r.tokens) for r in got) < 224   # a pool filled


@pytest.mark.parametrize('eot_bias,beam_size', [(0.0, 5), (0.11, 5)])
def test_dq_int4_beam_decode_matches_jax(jax_knobs, eot_bias, beam_size):
    """The quantized path's beam search: int8 weights (dq) and packed int4
    cross K/V on three windows, token for token, with EOT biased as in
    test_beam_decode_matches_jax so the pools fill. The logprob sums are
    held at 1e-5 relative."""
    from stable_ts_tpu.loaders import WhisperTPU
    from stable_ts_tpu.models.whisper.model import init_params, tiny_test_dims
    from stable_ts_tpu.models.whisper.tokenizer import synthetic_byte_ranks
    from stable_ts_tpu_torch.loaders import from_jax
    dims = tiny_test_dims()
    params = init_params(dims, seed=0)
    dec = params['decoder']
    axis = np.eye(dims.n_text_state, dtype=np.float32)[0]
    dec['ln'] = dict(dec['ln'], b=jnp.asarray(axis * 4.0))
    eot = WhisperTPU(dims, params, ranks=synthetic_byte_ranks()).get_tokenizer(
        'en', 'transcribe').eot
    dec['token_emb'] = dec['token_emb'].at[eot].set(jnp.asarray(axis * eot_bias))
    jax_model = WhisperTPU(dims, params, ranks=synthetic_byte_ranks(), dq=True)
    port_model = from_jax(jax_model, device='cpu')
    assert port_model.quantized
    mel = np.random.default_rng(6).standard_normal((3, 80, 3000)).astype(np.float32)
    mel[1] *= 0.0
    mel[2] *= 3.0
    kw = dict(language='en', temperature=0, beam_size=beam_size, kv_quant=4)
    ref = jax_model.decode(jnp.asarray(mel), **kw)
    got = port_model.decode(torch.from_numpy(mel), **kw)
    for a, b in zip(got, ref):
        assert a.tokens == b.tokens
        assert a.avg_logprob == pytest.approx(b.avg_logprob, rel=1e-5)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, rel=1e-5)
    if eot_bias:
        assert min(len(r.tokens) for r in got) < 224   # a pool filled


def test_beam_orderings_break_ties_as_jax():
    """Equal scores (banned tokens, the -1e30 rows of dead beams) keep the
    lower index first, as jax.lax.top_k and the stable jnp.argsort."""
    import jax
    from stable_ts_tpu_torch.models.whisper.decoding import _argsort_desc, _top_k
    x = np.full((3, 500), -1e30, np.float32)
    x[0, [7, 300]] = -2.0
    x[1, ::3] = -1e9 - 5.0          # many equal banned-token scores
    x[2] = np.round(np.random.default_rng(0).standard_normal(500), 1)
    vals, idx = _top_k(torch.from_numpy(x), 10)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), 10)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(_argsort_desc(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(x), axis=1)))


@pytest.mark.parametrize('length_penalty', [None, 0.6])
def test_best_of_selection_matches_jax(length_penalty):
    """JAX's decode_collect over numpy loop outputs against the port's
    select_best_of: the same chosen row, tokens and avg_logprob."""
    from stable_ts_tpu.models.whisper.decoding import (DecodingOptions,
                                                       PendingDecode,
                                                       decode_collect)
    from stable_ts_tpu.models.whisper.tokenizer import (WhisperTokenizer,
                                                        synthetic_byte_ranks)
    from stable_ts_tpu_torch.models.whisper.decoding import select_best_of
    tok = WhisperTokenizer(synthetic_byte_ranks(), multilingual=True,
                           num_languages=99, language='en', task='transcribe')
    rng = np.random.default_rng(7)
    batch, group, sample_begin, sample_len, ctx = 3, 4, 3, 20, 32
    rows = batch * group
    tokens = rng.integers(0, 200, (rows, ctx)).astype(np.int32)
    for r in range(rows):   # EOT at varied places, none in some rows
        at = rng.integers(sample_begin, sample_begin + sample_len + 6)
        if at < sample_begin + sample_len:
            tokens[r, at] = tok.eot
    tokens[5] = tokens[4]   # a tie: the first row must win
    sum_lp = (rng.standard_normal(rows) * 5 - 10).astype(np.float32)
    sum_lp[5] = sum_lp[4]
    no_speech = np.arange(rows, dtype=np.float32) / rows   # names the row
    opts = DecodingOptions(temperature=0.5, best_of=group,
                           length_penalty=length_penalty)
    pending = PendingDecode(kind='sample', xa=None, batch=batch, n_group=group,
                            options=opts, tokenizer=tok,
                            sample_begin=sample_begin, sample_len=sample_len,
                            no_speech_probs=no_speech, outputs=(tokens, sum_lp))
    ref = decode_collect(pending, with_features=False)
    got = select_best_of(tokens[:, sample_begin:sample_begin + sample_len],
                         sum_lp, group, tok.eot, length_penalty)
    assert len(got) == len(ref) == batch
    for (row, seq, avg), r in zip(got, ref):
        assert row == round(r.no_speech_prob * rows)
        assert [int(t) for t in seq] == r.tokens
        assert avg == r.avg_logprob


def test_sampler_frequencies_follow_softmax():
    """Chi-square of 40000 draws against softmax(filtered / T)."""
    from scipy.stats import chisquare
    from stable_ts_tpu_torch.models.whisper.decoding import sample_tokens
    logits = torch.tensor([0.3, -1.0, 2.0, 0.0, -1e9, 1.2, -0.5, 0.7])
    temperature, n = 0.7, 40000
    gen = torch.Generator().manual_seed(11)
    draws = sample_tokens(logits.expand(n, -1).contiguous(), temperature, gen)
    counts = np.bincount(draws.numpy(), minlength=len(logits))
    assert counts[4] == 0   # a banned token is never drawn
    probs = torch.softmax(logits / temperature, -1).double().numpy()
    live = probs > 0
    _, p_value = chisquare(counts[live], probs[live] / probs[live].sum() * n)
    assert p_value > 1e-3, (counts, probs * n)


def test_same_seed_same_samples(tiny_pair):
    from stable_ts_tpu_torch.models.whisper.decoding import DecodingOptions
    _, port_model = tiny_pair
    mel = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 80, 3000)).astype(np.float32))
    opts = DecodingOptions(language='en', temperature=0.8, best_of=3,
                           sample_len=16)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return [r.tokens for r in port_model.decode(mel, opts, generator=gen)]

    assert run(5) == run(5)
    assert run(None) == run(0) == run(None)   # no generator: seed 0 each call
    assert run(5) != run(6)


def test_ladder_visits_jax_rungs(tiny_pair, jax_knobs):
    """Forced fallback (logprob_threshold=100): every window runs every rung
    with the same options on both, and the segments keep the last rung."""
    jax_model, port_model = tiny_pair
    audio = _audio()
    ladder = (0.0, 0.5, 1.0)
    kw = dict(language='en', temperature=ladder, best_of=3,
              logprob_threshold=100, verbose=None)
    calls = {}
    for name, model in (('jax', jax_model), ('port', port_model)):
        seen = calls[name] = []
        real = model.decode

        def spy(features, options=None, *a, _real=real, _seen=seen, **k):
            _seen.append((options.temperature, options.best_of,
                          options.beam_size))
            return _real(features, options, *a, **k)

        model.decode = spy
        try:
            result = model.transcribe(audio, **kw)
        finally:
            del model.decode
        calls[name + '_temps'] = [s.temperature for s in result.segments]
    rung = [(0.0, None, None), (0.5, 3, None), (1.0, 3, None)]
    for name in ('jax', 'port'):
        seen = calls[name]
        assert len(seen) % len(ladder) == 0 and seen
        assert seen == rung * (len(seen) // len(ladder)), (name, seen)
        assert calls[name + '_temps'] and set(calls[name + '_temps']) == {1.0}


@pytest.mark.parametrize('mode', ['best_of', 'beam'])
def test_group_decoder_steps_match_jax(mode, monkeypatch):
    """decoder_step with q_per_kv (and, for beams, an ancestry table that
    mixes the group's rows) against JAX's: cross kernel in interpret mode,
    self-attention through its XLA ancestry gather."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    from stable_ts_tpu.models.whisper import model as jm
    from stable_ts_tpu_torch.models.whisper import model as pm
    from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    dims = tiny_test_dims()
    params = jm.init_params(jm.tiny_test_dims(), seed=9)
    model = from_jax_params(params, dims, device='cpu')
    rng = np.random.default_rng(10)
    windows, g, ctx, prompt = 2, 3, 128, 3
    rows = windows * g
    mel = rng.standard_normal((windows, 80, 3000)).astype(np.float32)
    xa = np.asarray(jm.encoder_apply(params['encoder'], jnp.asarray(mel), 2))
    xa_rows = np.repeat(xa, g, axis=0)
    tokens0 = rng.integers(0, 1800, (rows, prompt))
    _, cache_j = jm.decoder_prefill(params['decoder'], jnp.asarray(tokens0, jnp.int32),
                                    jnp.asarray(xa_rows), 2, ctx, int8_cache=True)
    _, cache_p = pm.decoder_prefill(model.decoder, torch.from_numpy(tokens0),
                                    torch.from_numpy(xa_rows.copy()), ctx)
    cross_j = jm.precompute_cross_kv_t(params['decoder'], jnp.asarray(xa),
                                       quantize=True)
    cross_p = pm.precompute_cross_kv_t(model.decoder, torch.from_numpy(xa.copy()),
                                       quantize=True)
    dec_jax = dict(params['decoder'])
    dec_jax['blocks'] = jm.fuse_self_qkv(dec_jax['blocks'])
    fused = pm.fuse_self_qkv(model.decoder)
    local = np.arange(rows) % g
    anc = np.repeat(local[:, None], ctx, axis=1).astype(np.int32)
    for step in range(6):
        pos = prompt + step
        if mode == 'beam':
            # a reshuffle: each row takes the history of a random sibling
            src = (np.arange(rows) // g) * g + rng.integers(0, g, rows)
            anc = anc[src]
            anc[:, pos] = local
        tok = rng.integers(0, 1800, (rows, 1))
        beam_kw = dict(anc=jnp.asarray(anc)) if mode == 'beam' else {}
        ref, cache_j = jm.decoder_step(dec_jax, jnp.asarray(tok, jnp.int32),
                                       jnp.int32(pos), cross_j, cache_j, 2,
                                       q_per_kv=g, **beam_kw)
        got = pm.decoder_step(model.decoder, torch.from_numpy(tok), pos, cross_p,
                              cache_p, fused, q_per_kv=g,
                              anc=torch.from_numpy(anc) if mode == 'beam' else None)
        ref = np.asarray(ref)
        rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert rel <= 1e-4, (step, rel)
        hidden = pm.decoder_step(model.decoder, torch.from_numpy(tok), pos,
                                 cross_p, cache_p, fused, q_per_kv=g,
                                 anc=torch.from_numpy(anc) if mode == 'beam' else None,
                                 return_hidden=True)
        assert hidden.shape == (rows, dims.n_text_state)
        assert torch.allclose(model.decoder.vocab_logits(hidden), got)
