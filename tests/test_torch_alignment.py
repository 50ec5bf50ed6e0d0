"""Dynamic alignment heads, the 'new' aligner and extra models in the port
against stable_ts_tpu on the CPU.

A model with no known alignment heads selects 6 heads per token by their
attention peaks (the reference's fallback); ``dynamic_heads`` asks for it
with any model, as an int or as 'count,iterations' (each pass after the
first scores the heads against the midpoints of the previous pass's DTW
jumps). The 'new' aligner scores every head by its column and row norms
(and coverage) and averages the top k; ``extra_models`` add their own
heads' weights and token probabilities. The same tiny models (``from_jax``
of JAX's ``load_test_model()``) transcribe the same seeded noise through
both packages, JAX with its greedy logit epilogue off: text, word-level SRT
bytes and every word's start and end must be equal. The head selection's
host code is the port's own copy and must equal JAX's exactly; the 'new'
aligner's device matrix must pick JAX's heads and agree within 1e-6."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _audio(seconds=20, seed=21):
    return (np.random.default_rng(seed).standard_normal(16000 * seconds)
            * 0.1).astype(np.float32)


def _words(result):
    return [(w.word, w.start, w.end) for s in result.segments for w in s.words]


@pytest.mark.parametrize('dynamic_heads', [None, 3, '3,2'],
                         ids=['no_heads_default', 'int_3', 'str_3_2'])
def test_dynamic_heads_transcribe_matches_jax(dynamic_heads, monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax()
    port_model = from_jax(jax_model, device='cpu')
    assert jax_model.alignment_heads is None and port_model.alignment_heads is None
    audio = _audio()
    kw = dict(language='en', temperature=0, verbose=None, dynamic_heads=dynamic_heads)
    ref = jax_model.transcribe(audio, **kw)
    got = port_model.transcribe(audio, **kw)
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _words(got) == _words(ref) and len(_words(got)) > 0


def test_port_test_model_without_heads_transcribes():
    """The port's own test model (weights from a torch Generator) knows no
    heads either, and transcribes with word timings on the defaults."""
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu')
    assert model.alignment_heads is None
    result = model.transcribe(_audio(8), language='en', temperature=0, verbose=None)
    words = [w for s in result.segments for w in s.words]
    assert words and all(0 <= w.start <= w.end <= 8 for w in words)


@pytest.mark.parametrize('spec', [None, False, 0, True, 1, 6, '4', '3,2', '5,3'])
def test_parse_dynamic_heads_matches_jax(spec):
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch.models.whisper import timing
    assert timing.parse_dynamic_heads(spec) == jax_timing.parse_dynamic_heads(spec)


@pytest.mark.parametrize('heads_count', [1, 6, 100])
@pytest.mark.parametrize('jumps', [False, True], ids=['own_peaks', 'jump_midpoints'])
@pytest.mark.parametrize('max_qk_len,medfilt', [(57, 7), (40, 1), (3, 7)])
def test_dynamic_head_weights_match_jax_exactly(heads_count, jumps, max_qk_len, medfilt):
    """The same (L, H, T, F) capture through both copies of the selection:
    equal bit for bit, with the heads' own argmax peaks and with the
    midpoints of given jumps; a crop narrower than the median filter's
    half-width passes through unfiltered in both."""
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch.models.whisper import timing
    rng = np.random.default_rng(heads_count + max_qk_len)
    qks = (rng.standard_normal((4, 6, 13, max_qk_len)) * 3).astype(np.float32)
    jump_indices = (np.sort(rng.integers(0, max_qk_len, 9)) if jumps else None)
    args = (qks, 3, max_qk_len, 1.0, medfilt, heads_count, jump_indices)
    got = timing._dynamic_head_weights(*args)
    ref = jax_timing._dynamic_head_weights(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def _jax_env(monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')


HEADS = [(0, 1), (1, 0), (1, 1)]
NEW_SETTINGS = dict(w_colnorm=1.0, w_rownorm=1.0, w_coverage=0.0)


def _capture(seed, L=4, H=6, T=13, F=1500):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, H, T, F)) * 3).astype(np.float32)


def _jax_new_matrix(qks, max_qk_len, topk, medfilt=7, **settings):
    import jax.numpy as jnp
    from stable_ts_tpu.models.whisper import timing as jax_timing
    return np.asarray(jax_timing._new_aligner_matrix(
        jnp.asarray(qks), max_qk_len, 3, 1.0, medfilt_width=medfilt, topk=topk,
        **settings))


@pytest.mark.parametrize('settings', [NEW_SETTINGS,
                                      dict(w_colnorm=1.0, w_rownorm=0.0, w_coverage=1.0),
                                      dict(w_colnorm=0.0, w_rownorm=2.0, w_coverage=0.5)],
                         ids=['default', 'colnorm_coverage', 'rownorm_coverage'])
@pytest.mark.parametrize('max_qk_len', [1500, 377], ids=['full_width', 'crop_377'])
def test_new_aligner_matrix_matches_jax(settings, max_qk_len):
    """The same (L, H, T, F) capture: the port's device matrix within 1e-6
    of JAX's ``_new_aligner_matrix``, and JAX's top-k heads, recovered one
    at a time from its matrices at k = 1..5 (k·M_k - (k-1)·M_(k-1) is the
    k-th head's column-normalized weights), are the port's, in order."""
    from stable_ts_tpu_torch.models.whisper import timing
    qks = _capture(max_qk_len)
    t = torch.from_numpy(qks)
    got = timing.new_aligner_matrix(t, max_qk_len, 3, 1.0, 7, 5, **settings)
    ref = _jax_new_matrix(qks, max_qk_len, 5, **settings)
    assert got.shape == ref.shape == (13 - 3 - 1, 1500)
    assert np.abs(got.numpy() - ref).max() <= 1e-6
    assert not got[:, max_qk_len:].any()
    idx, w = timing.new_aligner_top_heads(t, max_qk_len, 1.0, 7, 24, **settings)
    norm = w / torch.linalg.vector_norm(w, dim=-2, keepdim=True).clamp_min(1e-30)
    per_head = norm[:, 3:-1].numpy()     # (24, T', F), in the port's order
    jax_idx, prev = [], 0
    for k in range(1, 6):
        m_k = _jax_new_matrix(qks, max_qk_len, k, **settings)
        head = k * m_k - (k - 1) * prev
        jax_idx.append(int(idx[np.abs(per_head - head).max(axis=(1, 2)).argmin()]))
        prev = m_k
    assert jax_idx == idx[:5].tolist()


@pytest.mark.parametrize('max_qk_len,medfilt', [(57, 7), (40, 1), (3, 7)])
def test_new_aligner_host_twin_matches_jax(max_qk_len, medfilt):
    """NumPy input narrower than the capture takes the host twin (crop
    before the filter), equal to JAX's bit for bit."""
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch.models.whisper import timing
    qks = _capture(max_qk_len, T=11, F=80)
    args = (qks, max_qk_len, 3, 1.0, medfilt, 4, 1.0, 1.0, 0.5)
    got = timing.new_aligner_matrix(*args)
    ref = jax_timing.new_aligner_matrix(*args)
    assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
    assert np.array_equal(got, ref)
    assert np.array_equal(timing._new_aligner_matrix_host(*args),
                          jax_timing._new_aligner_matrix_host(*args))


@pytest.mark.parametrize('head_chunk', [1, 5, 7, 23])
def test_new_aligner_head_chunks_are_bit_identical(head_chunk):
    """Scoring the heads a chunk at a time keeps the unchunked result bit
    for bit: the same heads, the same order, the same matrix."""
    from stable_ts_tpu_torch.models.whisper import timing
    t = torch.from_numpy(_capture(head_chunk, T=17, F=600))
    args = (t, 411, 1.0, 7, 6, 1.0, 1.0, 0.5)
    idx, w = timing.new_aligner_top_heads(*args, head_chunk=head_chunk)
    ref_idx, ref_w = timing.new_aligner_top_heads(*args, head_chunk=24)
    assert torch.equal(idx, ref_idx) and torch.equal(w, ref_w)
    assert torch.equal(
        timing.new_aligner_matrix(t, 411, 3, 1.0, 7, 6, 1.0, 1.0, 0.5,
                                  head_chunk=head_chunk),
        timing.new_aligner_matrix(t, 411, 3, 1.0, 7, 6, 1.0, 1.0, 0.5))


def test_new_aligner_head_chunk_fits_the_budget():
    from stable_ts_tpu_torch.models.whisper import timing
    chunk = timing.new_aligner_head_chunk(229, 1500)
    assert 1 <= chunk < 32 * 20
    assert chunk * 229 * 1500 * timing._NEW_ALIGNER_BYTES_PER_CELL <= 1 << 30


@pytest.mark.parametrize('aligner', ['new', {'topk': 4}, {'w_coverage': 1.0}],
                         ids=['new', 'dict_topk_4', 'dict_w_coverage_1'])
def test_new_aligner_transcribe_matches_jax(aligner, monkeypatch):
    _jax_env(monkeypatch)
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    port_model = from_jax(jax_model, device='cpu')
    audio = _audio()
    kw = dict(language='en', temperature=0, verbose=None, aligner=aligner)
    ref = jax_model.transcribe(audio, **kw)
    got = port_model.transcribe(audio, **kw)
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _words(got) == _words(ref) and len(_words(got)) > 0


@pytest.mark.parametrize('main_heads,extra_heads',
                         [(HEADS, [(1, 0), (0, 0)]), (HEADS, None), (None, [(0, 1)])],
                         ids=['both_known', 'extra_dynamic', 'main_dynamic'])
def test_extra_models_transcribe_matches_jax(main_heads, extra_heads, monkeypatch):
    """One extra model (other weights), with known heads or none, beside a
    main model with known heads or none: text, SRT bytes, every word time
    and probability as JAX's."""
    _jax_env(monkeypatch)
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_main = load_jax(alignment_heads=main_heads)
    jax_extra = load_jax(seed=1, alignment_heads=extra_heads)
    port_main = from_jax(jax_main, device='cpu')
    port_extra = from_jax(jax_extra, device='cpu')
    audio = _audio()
    kw = dict(language='en', temperature=0, verbose=None)
    ref = jax_main.transcribe(audio, extra_models=[jax_extra], **kw)
    got = port_main.transcribe(audio, extra_models=[port_extra], **kw)
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _words(got) == _words(ref) and len(_words(got)) > 0
    assert ([w.probability for w in got.all_words()]
            == pytest.approx([w.probability for w in ref.all_words()], abs=1e-6))


def test_extra_model_identity_keeps_the_words():
    """extra_models=[model] duplicates the model's own weights: the words,
    times and probabilities are those of no extra model (JAX's
    test_extra_models_identity)."""
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu', alignment_heads=HEADS)
    audio = _audio(12)
    kw = dict(language='en', temperature=0, verbose=None)
    base = model.transcribe(audio, **kw)
    mixed = model.transcribe(audio, extra_models=[model], **kw)
    assert mixed.text == base.text

    def words(r):
        return [(w.word, w.start, w.end, round(w.probability, 6)) for w in r.all_words()]
    assert words(mixed) == words(base) and words(base)


def test_extra_models_reject_foreign_objects():
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu')
    with pytest.raises(NotImplementedError, match='extra_models'):
        model.transcribe(_audio(4), language='en', temperature=0, verbose=None,
                         extra_models=['not-a-model'])


def test_unknown_aligner_is_refused():
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu')
    with pytest.raises(ValueError, match='aligner'):
        model.transcribe(_audio(4), language='en', temperature=0, verbose=None,
                         aligner='newest')
