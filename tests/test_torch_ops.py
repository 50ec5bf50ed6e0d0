"""stable_ts_tpu_torch ops against stable_ts_tpu on the CPU: log-mel, the
median filter, the DTW cost (the kernel's plain twin vs the JAX scan and
the Pallas kernel in interpret mode), the DTW traceback, and the greedy
logit epilogue (the kernel's twin vs the Pallas kernel in interpret mode
and vs ``logit_aggregates_xla``, and the selection from its aggregates);
plus the port's restated dims table and decoding dataclasses."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _finite_close(got: np.ndarray, ref: np.ndarray, rel: float):
    """INF (1e30) borders equal; finite costs within ``rel`` of the
    largest finite cost."""
    border = ref >= 1e29
    np.testing.assert_array_equal(got >= 1e29, border)
    scale = np.abs(ref[~border]).max()
    err = np.abs(np.where(border, 0.0, got - ref)).max()
    assert err <= rel * scale, (err, scale)


# -- mel --------------------------------------------------------------------------------

@pytest.mark.parametrize('n_mels', [80, 128])
@pytest.mark.parametrize('int16', [False, True])
def test_log_mel_spectrogram_matches_jax(n_mels, int16):
    from stable_ts_tpu.ops.mel import log_mel_spectrogram as mel_jax
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(16000 * 7) * 0.1).astype(np.float32)
    if int16:
        audio = (audio * 32767).astype(np.int16)
    ref = np.asarray(mel_jax(audio, n_mels, padding=16000))
    got = log_mel_spectrogram(audio, n_mels, padding=16000).numpy()
    assert got.shape == ref.shape
    # same f32 DFT basis and filterbank; only the sums' order differs
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_log_mel_windowed_matches_jax():
    from stable_ts_tpu.ops.mel import log_mel_windowed as win_jax
    from stable_ts_tpu_torch.ops.mel import log_mel_windowed
    rng = np.random.default_rng(4)
    rows = np.zeros((2, 16000 * 5), np.float32)
    rows[0, :16000 * 3] = rng.standard_normal(16000 * 3) * 0.1
    rows[1, :16000 * 4] = rng.standard_normal(16000 * 4) * 0.05
    ref = np.asarray(win_jax(rows, 80))
    got = log_mel_windowed(rows, 80).numpy()
    assert got.shape == ref.shape == (2, 80, 3000)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# -- median filter --------------------------------------------------------------------

@pytest.mark.parametrize('width', [5, 7])
def test_median_filter_matches_jax_exactly(width):
    from stable_ts_tpu.ops.median import median_filter as med_jax
    from stable_ts_tpu_torch.ops.median import median_filter
    x = np.random.default_rng(5).standard_normal((3, 11, 120)).astype(np.float32)
    ref = np.asarray(med_jax(jnp.asarray(x), width))
    got = median_filter(torch.from_numpy(x), width).numpy()
    np.testing.assert_array_equal(got, ref)  # a median selects, never rounds


# -- DTW ----------------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(1, 15, 40), (2, 30, 300)])
def test_dtw_cost_twin_matches_jax_scan(shape):
    from stable_ts_tpu.ops.dtw import dtw_cost_jax
    from stable_ts_tpu_torch.ops.dtw import dtw_cost
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    got = dtw_cost(torch.from_numpy(x)).numpy()
    ref = np.stack([np.asarray(dtw_cost_jax(jnp.asarray(xb))) for xb in x])
    assert got.shape == (shape[0], shape[1] + 1, shape[2] + 1)
    # JAX sums the prefix in f32, the twin in f64 rounded once: the costs
    # (sums of up to N + M terms) agree to f32 rounding of the total
    _finite_close(got, ref, 1e-5)


def test_dtw_cost_twin_matches_pallas_interpret():
    from stable_ts_tpu.ops.dtw import dtw_cost_pallas
    from stable_ts_tpu_torch.ops.dtw import dtw_cost
    x = np.random.default_rng(7).standard_normal((2, 12, 200)).astype(np.float32)
    ref = np.asarray(dtw_cost_pallas(jnp.asarray(x), interpret=True))
    got = dtw_cost(torch.from_numpy(x)).numpy()
    # the TPU kernel's log-doubling prefix sums round in another order
    _finite_close(got, ref, 1e-5)


def _jumps_cases():
    rng = np.random.default_rng(8)
    rand = rng.standard_normal((25, 180)).astype(np.float32)
    flat = np.zeros((12, 90), np.float32)            # every move ties
    steps = np.repeat(np.arange(6, dtype=np.float32)[:, None], 60, 1)  # tied rows
    return [('random', rand, 25, 180), ('random_cropped', rand, 20, 140),
            ('flat', flat, 12, 90), ('tied_rows', steps, 6, 60)]


@pytest.mark.parametrize('case', _jumps_cases(), ids=lambda c: c[0])
def test_dtw_jumps_match_device_traceback(case):
    from stable_ts_tpu.ops.dtw import dtw_cost_jax, dtw_jumps_device
    from stable_ts_tpu_torch.ops.dtw import dtw_jumps
    _, x, n, m = case
    cost = np.asarray(dtw_cost_jax(jnp.asarray(x)))
    ref = np.asarray(dtw_jumps_device(jnp.asarray(cost[None]),
                                      jnp.asarray([n]), jnp.asarray([m])))[0]
    got = dtw_jumps(cost, n, m)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('case', _jumps_cases()[:3], ids=lambda c: c[0])
def test_dtw_jumps_from_twin_cost_match_jax(case):
    """End to end: the port's cost + traceback vs JAX's cost + traceback."""
    from stable_ts_tpu.ops.dtw import dtw_cost_jax, dtw_jumps_device
    from stable_ts_tpu_torch.ops.dtw import dtw_cost, dtw_jumps
    _, x, n, m = case
    cost_j = np.asarray(dtw_cost_jax(jnp.asarray(x)))
    ref = np.asarray(dtw_jumps_device(jnp.asarray(cost_j[None]),
                                      jnp.asarray([n]), jnp.asarray([m])))[0]
    got = dtw_jumps(dtw_cost(torch.from_numpy(x)).numpy(), n, m)
    np.testing.assert_array_equal(got, ref)


# -- plain data ---------------------------------------------------------------------------

def test_dims_table_matches_jax():
    from stable_ts_tpu.models.whisper.load import OPENAI_MODEL_DIMS as jax_dims
    from stable_ts_tpu.models.whisper.model import tiny_test_dims as jax_tiny
    from stable_ts_tpu_torch.models.whisper.dims import (OPENAI_MODEL_DIMS,
                                                         tiny_test_dims)
    assert OPENAI_MODEL_DIMS == jax_dims
    assert dataclasses.asdict(tiny_test_dims()) == dataclasses.asdict(jax_tiny())
    for name, dims in OPENAI_MODEL_DIMS.items():
        from stable_ts_tpu.models.whisper.model import ModelDimensions as JD
        from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions as TD
        jd, td = JD(**dims), TD(**dims)
        assert (jd.is_multilingual, jd.num_languages) == \
            (td.is_multilingual, td.num_languages), name


@pytest.mark.parametrize('cls', ['DecodingOptions', 'DecodingResult'])
def test_decoding_dataclass_fields_match_jax(cls):
    import stable_ts_tpu.models.whisper.decoding as jax_dec
    import stable_ts_tpu_torch.models.whisper.decoding as port_dec
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_dec, cls))]
    pf = [(f.name, f.default) for f in dataclasses.fields(getattr(port_dec, cls))]
    assert [n for n, _ in pf] == [n for n, _ in jf]
    same = [a == b or (a != a and b != b) for (_, a), (_, b) in zip(pf, jf)]
    assert all(same), (pf, jf)


def test_shared_tables_load_without_the_jax_model():
    """The tokenizer and head tables come from stable_ts_tpu's files, under
    the port's module names."""
    import sys
    from stable_ts_tpu_torch.models.whisper import alignment_heads, tokenizer
    assert tokenizer.__name__ == 'stable_ts_tpu_torch.models.whisper.tokenizer'
    assert 'stable_ts_tpu_torch.models.whisper.languages' in sys.modules
    heads = alignment_heads.get_alignment_heads('large-v3', 32, 20)
    assert heads and all(0 <= l < 32 and 0 <= h < 20 for l, h in heads)
    tok = tokenizer.WhisperTokenizer(tokenizer.synthetic_byte_ranks(),
                                     language='en', task='transcribe')
    assert tok.decode(tok.encode(' hello')) == ' hello'


@pytest.mark.parametrize('max_qk_len', [1500, 611, 4])
def test_legacy_head_weights_match_jax(max_qk_len):
    """Softmax over the real frames, per-column normalization, the reflect
    continuation at the crop boundary and the median filter (the short last
    window of a transcription takes the crop path)."""
    from stable_ts_tpu.models.whisper.timing import legacy_head_weights as lhw_jax
    from stable_ts_tpu_torch.models.whisper.timing import legacy_head_weights
    qk = (np.random.default_rng(9).standard_normal((3, 17, 1500)) * 3)
    qk = jnp.asarray(qk, jnp.bfloat16)  # the capture is stored bf16
    ref = np.asarray(lhw_jax(qk, max_qk_len, 3, 1.0, 7))
    got = legacy_head_weights(torch.from_numpy(np.asarray(qk, np.float32)),
                              max_qk_len, 3, 1.0, 7).numpy()
    assert got.shape == ref.shape == (3, 13, 1500)
    # f32 softmax and moments summed in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# -- logit epilogue --------------------------------------------------------------------

EPI_V, EPI_D, EPI_TS, EPI_EOT = 1900, 256, 1500, 1400


def _epilogue_case(seed, b):
    """Seeded x, embedding, suppress vector, silence mask and grammar flags
    ((4, B) f32 as JAX takes them), with rows of every grammar state."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, EPI_D)) * 0.2).astype(np.float32)
    emb = (rng.standard_normal((EPI_V, EPI_D)) * 0.2).astype(np.float32)
    suppress = np.where(rng.random(EPI_V) < 0.05, -1e9, 0.0).astype(np.float32)
    sil = np.zeros((b, EPI_V), np.float32)
    sil[:, EPI_TS:] = np.where(rng.random((b, EPI_V - EPI_TS)) < 0.3, -1e9, 0.0)
    flags = np.stack([rng.random(b) < 0.4, rng.random(b) < 0.4,
                      rng.random(b) < 0.6,
                      rng.integers(0, (EPI_V - EPI_TS) // 2, b)]).astype(np.float32)
    flags[1] = np.where(flags[0] > 0, 0.0, flags[1])   # the bans exclude each other
    return x, emb, suppress, sil, flags


def _check_aggregates(got, ref):
    """Argmax ids equal; maxima and sums of exponentials within 1e-5
    relative in f32 (the sums run in another order)."""
    np.testing.assert_array_equal(got[:, [1, 4]], ref[:, [1, 4]])
    np.testing.assert_allclose(got[:, [0, 3]], ref[:, [0, 3]], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, [2, 5]], ref[:, [2, 5]], rtol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('with_grammar', [True, False])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_epilogue_twin_matches_pallas_interpret(seed, with_grammar, dtype):
    from stable_ts_tpu.ops.logit_epilogue import (fused_logit_aggregates as jax_agg,
                                                  logit_aggregates_xla,
                                                  prepare_epilogue_operands)
    from stable_ts_tpu_torch.ops.logit_epilogue import (fused_logit_aggregates,
                                                        grammar_filter)
    x, emb, suppress, sil, flags = _epilogue_case(seed, b=6)
    jdt = jnp.dtype(dtype)
    prepared = prepare_epilogue_operands(jnp.asarray(emb, jdt), jnp.asarray(suppress),
                                         jnp.asarray(sil), ts_begin=EPI_TS,
                                         block_v=512)
    ref = np.asarray(jax_agg(jnp.asarray(x), prepared, jnp.asarray(flags),
                             ts_begin=EPI_TS, eot=EPI_EOT,
                             with_grammar=with_grammar, interpret=True))
    emb_t = torch.from_numpy(emb).to(getattr(torch, dtype))
    flags_t = torch.from_numpy(flags.T.astype(np.int32).copy())
    got = fused_logit_aggregates(torch.from_numpy(x), emb_t, torch.from_numpy(suppress),
                                 torch.from_numpy(sil), flags_t, EPI_TS, EPI_EOT,
                                 with_grammar).numpy()
    _check_aggregates(got, ref)
    # and against JAX's reduction of the same filtered logits
    logits = torch.from_numpy(x).to(emb_t.dtype).float() @ emb_t.float().t()
    filtered = grammar_filter(logits, torch.from_numpy(suppress),
                              torch.from_numpy(sil), flags_t, EPI_TS, EPI_EOT,
                              with_grammar)
    _check_aggregates(got, np.asarray(logit_aggregates_xla(
        jnp.asarray(filtered.numpy()), EPI_TS)))


def test_epilogue_without_silence_mask_adds_nothing():
    from stable_ts_tpu_torch.ops.logit_epilogue import fused_logit_aggregates
    x, emb, suppress, _, flags = _epilogue_case(3, b=2)
    args = [torch.from_numpy(a) for a in (x, emb, suppress)]
    flags_t = torch.from_numpy(flags.T.astype(np.int32).copy())
    zeros = torch.zeros((2, EPI_V))
    assert torch.equal(
        fused_logit_aggregates(*args, None, flags_t, EPI_TS, EPI_EOT),
        fused_logit_aggregates(*args, zeros, flags_t, EPI_TS, EPI_EOT))


def test_logit_aggregates_keep_the_first_maximum():
    """Equal maxima: the lowest id wins in both parts, as jnp.argmax; an
    all-banned part sums its -1e9 entries."""
    from stable_ts_tpu.ops.logit_epilogue import logit_aggregates_xla
    from stable_ts_tpu_torch.ops.logit_epilogue import logit_aggregates
    f = np.full((2, 12), 0.5, np.float32)
    f[0, [3, 7, 9]] = 2.0          # ties in the text part (ids < 8)...
    f[0, [10, 11]] = 3.0           # ...and in the timestamp part
    f[1, 8:] = -1e9                # every timestamp banned
    got = logit_aggregates(torch.from_numpy(f), 8).numpy()
    np.testing.assert_array_equal(got[:, [1, 4]], [[3, 10], [0, 8]])
    np.testing.assert_allclose(got, np.asarray(logit_aggregates_xla(jnp.asarray(f), 8)),
                               rtol=1e-6)


@pytest.mark.parametrize('with_grammar', [True, False])
@pytest.mark.parametrize('seed', [3, 4])
def test_select_from_aggregates_matches_jax(seed, with_grammar):
    """The next token and its logprob from the aggregates, with the
    force-timestamp rule, equal to JAX's."""
    from stable_ts_tpu.ops.logit_epilogue import logit_aggregates_xla
    from stable_ts_tpu.ops.logit_epilogue import select_from_aggregates as jax_select
    from stable_ts_tpu_torch.ops.logit_epilogue import select_from_aggregates
    x, emb, _, _, _ = _epilogue_case(seed, b=16)
    logits = x @ emb.T
    logits[:, EPI_TS:] += np.linspace(-12, 4, 16, dtype=np.float32)[:, None]
    agg = np.array(logit_aggregates_xla(jnp.asarray(logits), EPI_TS))
    ref_tok, ref_lp = jax_select(jnp.asarray(agg), with_grammar=with_grammar)
    tok, lp = select_from_aggregates(torch.from_numpy(agg), with_grammar)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    assert len(set((tok.numpy() >= EPI_TS).tolist())) == 2   # both parts chosen
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=1e-6, atol=1e-6)
