"""Timestamp refinement in the port (``refine`` and its probability
functions) against stable_ts_tpu on the CPU.

The tiny models are ``from_jax`` of JAX's ``load_test_model``, with the
alignment heads [(0, 1), (1, 0), (1, 1)] and with none. JAX runs as its own
tests run it on the CPU. Stated tolerances: probabilities within 1e-6,
mels within 1e-5; ranks, masks, words, starts, ends and SRT bytes equal.

- the muted-row rebuild and its mel (``_muted_rows``, ``_masked_mel_body``)
  on seeded interval sets with empty slots, touching boundaries, a span of
  at most N_FFT // 2 + 1 samples and padding rows (t_real == 0), against
  the host path's rows and JAX's mel; ``_refine_mel_batch`` against JAX's;
- one interval round and one audio-mode round of the batch function
  against JAX's on the same requests, the interval round against both of
  JAX's interval branches (fused and unfused);
- ``model.refine`` against JAX's from JAX's ``align`` result (8 s of
  noise) and from its ``transcribe_batched`` result (30 s of noise), with
  ``parallel`` True and False and steps 'se', 's' and 'e'; from its
  ``align_words`` result over 45 s (two spans, so two span groups);
- the port's own invariants, as JAX's tests pin them for JAX: interval
  mode equals audio mode, the two span groups equal one (through
  launch/collect and under STABLE_TS_TPU_REFINE_PIPE=0), a span's replies
  do not depend on the spans batched beside it, parallel equals
  sequential, tiny audio does not crash; ``parallel`` defaults to on only
  for a CUDA model.

Random weights give every word a probability far below the default
``prob_threshold`` of 0.5, which ends every bisection at its baseline
probe; ``prob_threshold=0.0`` makes the rounds run."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)
SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]
ALIGN_TEXT = ' hello world this is a longer test of refinement'
SEGMENTS = [dict(start=9.0 * i, end=9.0 * i + 7.5,
                 text=' ' + ' '.join(f'w{i}{j}' for j in range(4)))
            for i in range(5)]


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


def _noise(seconds, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(int(SR * seconds))
            * scale).astype(np.float32)


@pytest.fixture(scope='module')
def sources(known):
    """JAX's results to refine: ``align`` of 8 words over 8 s,
    ``transcribe_batched`` of 30 s of noise, and ``align_words`` of five
    segments over 45 s, whose words make two spans of at most 30 s."""
    jax_model = known[0]
    kw = dict(language='en', verbose=None)
    align_audio = _noise(8, seed=4)
    aligned = jax_model.align(align_audio, ALIGN_TEXT, **kw)
    tb_audio = _noise(30, seed=7, scale=0.1)
    transcribed = jax_model.transcribe_batched(tb_audio, **kw)
    aw_audio = _noise(45, seed=4)
    aligned_words = jax_model.align_words(aw_audio, [dict(s) for s in SEGMENTS],
                                          **kw)
    assert aligned.has_words and transcribed.has_words and aligned_words.has_words
    return {'align': (align_audio, aligned.to_dict()),
            'transcribe_batched': (tb_audio, transcribed.to_dict()),
            'align_words': (aw_audio, aligned_words.to_dict())}


def _results(data):
    from stable_ts_tpu.result import WhisperResult as JaxResult
    from stable_ts_tpu_torch.result import WhisperResult
    return JaxResult(data), WhisperResult(data)


def _times(result):
    return [(w.word, w.start, w.end) for w in result.all_words()]


def _assert_same(got, ref):
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _times(got) == _times(ref) and len(_times(got)) > 0
    assert ([w.probability for w in got.all_words()]
            == pytest.approx([w.probability for w in ref.all_words()], abs=1e-6))


# -- the muted rows and their mels ---------------------------------------------------------

def _interval_case(seed=0):
    """Spans of 1.3 s, 0.8 s, 150 samples (<= N_FFT // 2 + 1) and 2 s, in
    a bucket of 4 s, and a padding span (t_real == 0); each row gets a few
    disjoint intervals, empty slots (lo == hi, at 0 and mid-row) and two
    intervals that touch."""
    rng = np.random.default_rng(seed)
    t_bucket = 4 * SR
    t_real = np.array([int(1.3 * SR), int(0.8 * SR), 150, 2 * SR, 0], np.int32)
    clean = np.zeros((len(t_real), t_bucket), np.float32)
    for i, t in enumerate(t_real):
        clean[i, :t] = rng.standard_normal(t) * 0.3
    w = 6
    lo = np.zeros((2 * len(t_real), w), np.int32)
    hi = np.zeros((2 * len(t_real), w), np.int32)
    for r in range(2 * len(t_real)):
        t = int(t_real[r // 2])
        if t == 0:
            continue
        cuts = np.sort(rng.choice(np.arange(1, t), size=4, replace=False))
        lo[r, :2] = cuts[[0, 2]]
        hi[r, :2] = cuts[[1, 3]]
        if r % 3 == 0:          # two intervals that touch: [a, b) [b, c)
            lo[r, 2], hi[r, 2] = cuts[3], min(t, cuts[3] + 37)
        lo[r, 3] = hi[r, 3] = cuts[1]      # an empty slot mid-row
    return clean, t_real, lo, hi


def _host_rows(clean, t_real, lo, hi):
    """What the host path feeds the STFT: each muted row, np.pad 'reflect'
    continued by 200 samples, zero-padded to the bucket."""
    from stable_ts_tpu_torch.constants import N_FFT
    rows = np.zeros((2 * len(t_real), clean.shape[1]), np.float32)
    masks = np.zeros(rows.shape, bool)
    for r in range(rows.shape[0]):
        t = int(t_real[r // 2])
        row = clean[r // 2, :t].copy()
        for a, b in zip(lo[r], hi[r]):
            masks[r, a:b] = True
            row[a:b] = 0
        rows[r, :t] = row
        refl = min(N_FFT // 2, t - 1)
        if refl > 0:
            rows[r, t:t + refl] = np.pad(row, (0, refl), mode='reflect')[t:]
    return rows, masks[:, :clean.shape[1]]


def test_muted_rows_rebuild_the_host_rows():
    from stable_ts_tpu_torch.alignment import _muted_rows
    clean, t_real, lo, hi = _interval_case()
    ref_rows, ref_mask = _host_rows(clean, t_real, lo, hi)
    got = _muted_rows(*(torch.from_numpy(a) for a in (clean, t_real, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), ref_rows)
    # the mute mask, read off all-ones audio
    ones = _muted_rows(torch.ones(clean.shape), torch.from_numpy(t_real),
                       torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    for r in range(ones.shape[0]):
        t = int(t_real[r // 2])
        np.testing.assert_array_equal(ones[r, :t] == 0, ref_mask[r, :t])


@pytest.mark.parametrize('seed', [0, 1])
def test_masked_mel_matches_jax(seed):
    import jax.numpy as jnp
    from stable_ts_tpu.alignment import _masked_mel_body as jax_body
    from stable_ts_tpu_torch.alignment import _masked_mel_body
    clean, t_real, lo, hi = _interval_case(seed)
    ref = np.asarray(jax_body(*(jnp.asarray(a) for a in (clean, t_real, lo, hi)),
                              80))
    got = _masked_mel_body(*(torch.from_numpy(a) for a in (clean, t_real, lo, hi)),
                           80).numpy()
    assert got.shape == ref.shape == (2 * len(t_real), 80, 3000)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert not got[-2:].any()           # the padding span's rows are zeros


def test_refine_mel_batch_matches_jax():
    import jax.numpy as jnp
    from stable_ts_tpu.alignment import _refine_mel_batch as jax_mel
    from stable_ts_tpu_torch.alignment import _refine_mel_batch
    audio = _noise(3.5, seed=2).reshape(1, -1).repeat(4, 0)
    frames = np.array([300, 120, 0, 349], np.int32)
    ref = np.asarray(jax_mel(jnp.asarray(audio), jnp.asarray(frames), n_mels=80))
    got = _refine_mel_batch(torch.from_numpy(audio), torch.from_numpy(frames),
                            80).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# -- one round of the batch function -------------------------------------------------------

def _requests(tokenizer, probe_type, materialize=False):
    clean, t_real, lo, hi = _interval_case(3)
    texts = [' alpha beta', ' gamma', ' delta epsilon zeta', ' eta']
    requests = []
    for i, text in enumerate(texts):
        t = int(t_real[i])
        rows, los, his = [], [], []
        for r in (0, 1):
            for a, b in zip(lo[2 * i + r], hi[2 * i + r]):
                if a < b:
                    rows.append(r)
                    los.append(a)
                    his.append(b)
        probe = probe_type(clean[i, :t].copy(), np.asarray(rows, np.int64),
                               np.asarray(los, np.int64),
                               np.asarray(his, np.int64), epoch=1)
        if materialize:
            audio = np.repeat(probe.clean[None], 2, axis=0)
            for r, a, b in zip(rows, los, his):
                audio[r, a:b] = 0
            probe = audio
        requests.append((probe, tokenizer.encode(text)))
    return requests


@pytest.mark.parametrize('mode', ['fused', 'unfused', 'audio'])
def test_one_round_matches_jax(known, mode, monkeypatch):
    """The port's one interval round against JAX's fused and unfused
    rounds (JAX's switch; the port has one interval path), and its audio
    round against JAX's."""
    from stable_ts_tpu import alignment as jax_alignment
    from stable_ts_tpu.non_whisper.refinement import MutedSpanProbe as JaxProbe
    from stable_ts_tpu_torch import alignment
    from stable_ts_tpu_torch.non_whisper.refinement import MutedSpanProbe
    monkeypatch.setenv('STABLE_TS_TPU_REFINE_FUSED', '0' if mode == 'unfused' else '1')
    jax_model, port_model = known
    tokenizer = port_model.get_tokenizer(language='en', task='transcribe')
    jax_tok = jax_model.get_tokenizer(language='en', task='transcribe')
    materialize = mode == 'audio'
    ref_fn = jax_alignment._whisper_refinement_batch_func(jax_model, jax_tok)
    got_fn = alignment._whisper_refinement_batch_func(port_model, tokenizer)
    ref = ref_fn.collect(ref_fn.launch(
        _requests(jax_tok, JaxProbe, materialize), key=0))
    got = got_fn.collect(got_fn.launch(
        _requests(tokenizer, MutedSpanProbe, materialize), key=0))
    assert len(got) == len(ref) == 4
    for (gp, gr), (rp, rr) in zip(got, ref):
        assert gp.shape == rp.shape and gp.shape[0] == 2
        np.testing.assert_allclose(gp, rp, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gr, rr)


def test_sequential_probe_matches_jax(known):
    from stable_ts_tpu import alignment as jax_alignment
    from stable_ts_tpu_torch import alignment
    jax_model, port_model = known
    tokenizer = port_model.get_tokenizer(language='en', task='transcribe')
    from stable_ts_tpu_torch.non_whisper.refinement import MutedSpanProbe
    (audio, tokens), = _requests(tokenizer, MutedSpanProbe, materialize=True)[:1]
    ref = jax_alignment._whisper_refinement_func(
        jax_model, jax_model.get_tokenizer(language='en', task='transcribe'))(
            audio, tokens)
    got = alignment._whisper_refinement_func(port_model, tokenizer)(audio, tokens)
    assert got.shape == ref.shape == (2, len(tokens), tokenizer.eot)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# -- refine against JAX ----------------------------------------------------------------------

@pytest.mark.parametrize('steps', ['se', 's', 'e'])
@pytest.mark.parametrize('parallel', [True, False])
@pytest.mark.parametrize('source', ['align', 'transcribe_batched'])
def test_refine_matches_jax(known, sources, source, parallel, steps):
    jax_model, port_model = known
    audio, data = sources[source]
    ref_in, got_in = _results(data)
    kw = dict(steps=steps, parallel=parallel, prob_threshold=0.0, verbose=None)
    ref = jax_model.refine(audio, ref_in, inplace=False, **kw)
    got = port_model.refine(audio, got_in, inplace=False, **kw)
    _assert_same(got, ref)
    if steps == 'se':
        moved = [a != b for a, b in zip(_times(got), _times(got_in))]
        assert any(moved), 'no word time moved: no bisection round ran'


@pytest.mark.parametrize('parallel', [True, False])
def test_refine_of_two_spans_matches_jax(known, sources, parallel):
    """Two spans: with ``parallel`` the rounds run as two span groups."""
    jax_model, port_model = known
    audio, data = sources['align_words']
    ref_in, got_in = _results(data)
    kw = dict(parallel=parallel, prob_threshold=0.0, verbose=None)
    _assert_same(port_model.refine(audio, got_in, inplace=False, **kw),
                 jax_model.refine(audio, ref_in, inplace=False, **kw))


@pytest.mark.parametrize('source', ['align', 'transcribe_batched'])
def test_refine_matches_jax_at_the_default_threshold(known, sources, source):
    jax_model, port_model = known
    audio, data = sources[source]
    ref_in, got_in = _results(data)
    kw = dict(parallel=True, verbose=None)
    _assert_same(port_model.refine(audio, got_in, inplace=False, **kw),
                 jax_model.refine(audio, ref_in, inplace=False, **kw))


def test_refine_of_words_without_probabilities_matches_jax(no_heads):
    """A result without word probabilities is aligned first
    (``align_words``), here on the model with no known heads."""
    jax_model, port_model = no_heads
    audio = _noise(4, seed=9)
    data = dict(language='en', segments=[
        dict(start=0.5, end=1.8, text=' hello world'),
        dict(start=2.0, end=3.5, text=' how are you')])
    ref_in, got_in = _results(data)
    kw = dict(prob_threshold=0.0, verbose=None)
    _assert_same(port_model.refine(audio, got_in, parallel=True, **kw),
                 jax_model.refine(audio, ref_in, parallel=True, **kw))


# -- the port's own invariants ------------------------------------------------------------

def _refine(model, audio, data, **kw):
    from stable_ts_tpu_torch.result import WhisperResult
    return model.refine(audio, WhisperResult(data), inplace=False,
                        prob_threshold=0.0, verbose=None, **kw)


@pytest.mark.parametrize('env', [('STABLE_TS_TPU_REFINE_INTERVALS', '0'),
                                 ('STABLE_TS_TPU_REFINE_PIPE', '0')])
def test_switches_keep_the_timestamps(known, sources, env, monkeypatch):
    """Audio mode equals interval mode (tests/test_refine_intervals.py:51-80),
    and one round group the pipeline's two."""
    port_model = known[1]
    audio, data = sources['align']
    ref = _refine(port_model, audio, data, parallel=True)
    monkeypatch.setenv(*env)
    assert _times(_refine(port_model, audio, data, parallel=True)) == _times(ref)


@pytest.mark.parametrize('subset', [[0], [2, 3], [1, 2, 3]])
def test_round_replies_do_not_depend_on_the_batch(known, subset):
    """A span's interval-round reply is the same whether it runs alone or
    beside other spans (the slot gather, padding slots up to a power of
    two, wider interval and token buckets): each subset of the four spans,
    launched on its own, gives the replies of the full round."""
    from stable_ts_tpu_torch import alignment
    from stable_ts_tpu_torch.non_whisper.refinement import MutedSpanProbe
    port_model = known[1]
    tokenizer = port_model.get_tokenizer(language='en', task='transcribe')
    fn = alignment._whisper_refinement_batch_func(port_model, tokenizer)
    requests = _requests(tokenizer, MutedSpanProbe)
    full = fn.collect(fn.launch(requests, key=0))
    part = fn.collect(fn.launch([requests[i] for i in subset], key=1))
    for i, (gp, gr) in zip(subset, part):
        np.testing.assert_allclose(gp, full[i][0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gr, full[i][1])


def test_two_span_groups_equal_one(known, sources, monkeypatch):
    """The pipeline's two groups (``launch`` with keys 0 and 1) give the
    timestamps of one group with launch/collect stripped off
    (tests/test_refine_pipeline.py:109-148)."""
    from stable_ts_tpu_torch import alignment
    port_model = known[1]
    audio, data = sources['align_words']
    orig = alignment._whisper_refinement_batch_func
    keys = []

    def spy(*a, **kw):
        fn = orig(*a, **kw)
        launch = fn.launch

        def counted(requests, key=0):
            keys.append(key)
            return launch(requests, key)
        fn.launch = counted
        return fn

    def no_pipeline(*a, **kw):
        fn = orig(*a, **kw)
        del fn.launch, fn.collect
        return fn

    monkeypatch.setattr(alignment, '_whisper_refinement_batch_func', spy)
    piped = _refine(port_model, audio, data, parallel=True)
    assert set(keys) == {0, 1}
    monkeypatch.setattr(alignment, '_whisper_refinement_batch_func', no_pipeline)
    assert _times(_refine(port_model, audio, data, parallel=True)) == _times(piped)


@pytest.mark.parametrize('source', ['align', 'align_words'])
def test_parallel_matches_sequential(known, sources, source):
    """tests/test_aligner.py:228-240, on the port."""
    port_model = known[1]
    audio, data = sources[source]
    assert (_times(_refine(port_model, audio, data, parallel=False))
            == _times(_refine(port_model, audio, data, parallel=True)))


@pytest.mark.parametrize('intervals', ['1', '0'])
def test_tiny_audio_does_not_crash(known, intervals, monkeypatch):
    """150 samples (< N_FFT // 2 + 2) through the batched probability
    function, in interval mode and in audio mode, where the reflect copy's
    stop guard matters (tests/test_aligner.py:206-226). The sequential
    path takes no such audio in either package."""
    port_model = known[1]
    tokenizer = port_model.get_tokenizer(language='en', task='transcribe')
    words = [dict(word=' a', start=0.001, end=0.005, probability=0.9,
                  tokens=tokenizer.encode(' a')),
             dict(word=' b', start=0.005, end=0.009, probability=0.9,
                  tokens=tokenizer.encode(' b'))]
    data = dict(text=' a b', language='en', segments=[
        dict(start=0.001, end=0.009, text=' a b', words=words)])
    monkeypatch.setenv('STABLE_TS_TPU_REFINE_INTERVALS', intervals)
    assert _refine(port_model, _noise(150 / SR, seed=7), data,
                   parallel=True).has_words


def test_parallel_defaults_to_the_card(known, monkeypatch):
    """``parallel=None`` is on only for a model on a CUDA device."""
    from stable_ts_tpu_torch import alignment
    built = []
    orig = alignment._whisper_refinement_batch_func

    def spy(*a, **kw):
        built.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(alignment, '_whisper_refinement_batch_func', spy)
    port_model = known[1]
    audio = _noise(3, seed=1)
    base = port_model.align(audio, ' hello world', language='en', verbose=None)
    assert port_model.refine(audio, base, verbose=None).has_words
    assert not built
    port_model.refine(audio, base, verbose=None, parallel=True)
    assert built
