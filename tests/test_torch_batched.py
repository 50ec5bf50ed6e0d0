"""The port's batched driver against stable_ts_tpu's on the CPU.

The same tiny model (``from_jax`` of JAX's ``load_test_model()``, known
heads) runs ``transcribe_batched`` in both packages, JAX as its tests run
it off the TPU (the cross kernel in interpret mode, the int8 self cache,
the greedy epilogue off). Parity means equal text, equal word-level SRT
bytes and every word's text, start and end equal, at ``temperature=0``:
the rungs above 0 sample from another generator in each package.

Besides parity (window groups of 1, 2 and 8 windows, prompt chaining,
clips, the silence re-seek rule, the silence mask with no gap padding,
resuming, beams, int8 cross K/V, ``dq``, int16 PCM): the encoder runs
once a group across the whole fallback ladder, retries decode
power-of-two row buckets, progress is monotone and the bar follows
``verbose``, options are checked as JAX checks them, the loader is read a
window at a time, an out-of-memory error halves the batch and leaves
nothing of the failed attempt alive, the capacity cap reads the card's
memory, and ``decode_collect(decode_launch(...))`` gives JAX's results."""
import warnings
import weakref

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]


@pytest.fixture(scope='module', autouse=True)
def jax_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('STABLE_TS_TPU_CROSS', 'interpret')
        mp.setenv('STABLE_TS_TPU_SELFKV', '1')
        mp.setenv('STABLE_TS_TPU_EPI', '0')
        yield


@pytest.fixture(scope='module')
def pair():
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    return jax_model, from_jax(jax_model, device='cpu')


@pytest.fixture(scope='module')
def long_audio():
    """70 s: 8 s of tone, 4 s of silence, six times (JAX's fixture)."""
    t = np.arange(SR * 8) / SR
    tone = (np.sin(2 * np.pi * 440 * t) * 0.4).astype(np.float32)
    return np.concatenate([tone, np.zeros(SR * 4, np.float32)] * 6)[:SR * 70]


def _silence_heavy():
    """A speech-like burst, 12 s of silence starting mid-window, a burst."""
    rng = np.random.default_rng(3)
    t = np.arange(SR * 10) / SR
    tone = (np.sin(2 * np.pi * 330 * t)
            * (0.3 + 0.2 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
    tone += rng.standard_normal(tone.shape).astype(np.float32) * 0.01
    return np.concatenate([tone, np.zeros(SR * 12, np.float32), tone,
                           np.zeros(SR * 2, np.float32)])


def _layout(seed):
    """JAX's seeded speech/silence layouts (test_batched_round3.py)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(rng.integers(3, 6)):
        n = int(float(rng.uniform(3.0, 14.0)) * SR)
        t = np.arange(n) / SR
        tone = (np.sin(2 * np.pi * rng.uniform(200, 500) * t)
                * (0.3 + 0.2 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
        tone += rng.standard_normal(n).astype(np.float32) * 0.01
        parts.append(tone)
        parts.append(np.zeros(int(float(rng.uniform(6.0, 13.0)) * SR), np.float32))
    return np.concatenate(parts)


def _noise(seconds, seed=9):
    return (np.random.default_rng(seed).standard_normal(SR * seconds) * 0.2
            ).astype(np.float32)


def _words(result):
    return [(w.word, w.start, w.end) for s in result.segments for w in s.words]


def _assert_same(got, ref):
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _words(got) == _words(ref) and len(_words(got)) > 0


@pytest.mark.parametrize('batch_size', [1, 2, 8])
def test_batched_matches_jax(pair, long_audio, batch_size):
    """Three windows in groups of 1, 2 (a full and a padded group) and 8
    (one group, five rows padded)."""
    jax_model, port_model = pair
    kw = dict(language='en', temperature=0, verbose=None, batch_size=batch_size)
    _assert_same(port_model.transcribe_batched(long_audio, **kw),
                 jax_model.transcribe_batched(long_audio, **kw))


@pytest.mark.parametrize('case', [
    'condition_prompt', 'clip_timestamps', 'nonspeech_skip_trim',
    'nonspeech_skip_layout_11', 'nonspeech_skip_layout_23',
    'nonspeech_skip_layout_47', 'suppress_ts_no_gap_padding', 'resume',
    'beam2_batch3', 'kv_quant_int8'])
def test_batched_options_match_jax(pair, long_audio, case, tmp_path):
    """Each option through both drivers at temperature 0: prompts chained
    over three groups from an initial prompt; clipped sections; the
    nonspeech_skip re-seek rule (a silence starting mid-window, and JAX's
    three seeded layouts); the silence mask on the timestamp tokens with no
    gap padding; resuming a result JAX wrote for the first 30 s; two
    beams in groups of three windows; int8 cross K/V."""
    jax_model, port_model = pair
    audio = long_audio
    kw = dict(language='en', temperature=0, verbose=None, batch_size=2)
    if case == 'condition_prompt':
        kw.update(batch_size=1, condition_on_previous_text=True,
                  initial_prompt='hello there')
    elif case == 'clip_timestamps':
        kw.update(clip_timestamps='3,15,40,62')
    elif case.startswith('nonspeech_skip'):
        audio = (_silence_heavy() if case.endswith('trim')
                 else _layout(int(case.rsplit('_', 1)[1])))
        kw.update(nonspeech_skip=5.0)
    elif case == 'suppress_ts_no_gap_padding':
        audio = _silence_heavy()
        kw.update(suppress_ts_tokens=True, gap_padding=None)
    elif case == 'resume':
        audio = _noise(70)
        path = str(tmp_path / 'part.json')
        jax_model.transcribe_batched(audio[:SR * 30], **kw).save_as_json(path)
        kw.update(resume=path + '+')
    elif case == 'beam2_batch3':
        # on the tone fixture one beam word starts 1.18 s apart: the bf16
        # capture differs from JAX's in last bits (f32 products summed in
        # another order) and the DTW path crosses the silence at 68-70 s on
        # a near-tie; noise, as the sequential beam case uses, has none
        audio = _noise(70)
        kw.update(beam_size=2, batch_size=3)
    elif case == 'kv_quant_int8':
        kw.update(kv_quant=True)
    _assert_same(port_model.transcribe_batched(audio, **kw),
                 jax_model.transcribe_batched(audio, **kw))


def test_dq_batched_matches_jax(long_audio):
    """A dq model (int8 weights through the weight-only matmul) on int8
    cross K/V."""
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS, dq=True)
    port_model = from_jax(jax_model, device='cpu')
    assert port_model.quantized
    kw = dict(language='en', temperature=0, verbose=None, batch_size=2,
              kv_quant=True)
    _assert_same(port_model.transcribe_batched(long_audio, **kw),
                 jax_model.transcribe_batched(long_audio, **kw))


def _pcm():
    rng = np.random.default_rng(7)
    t = np.arange(SR * 40) / SR
    sig = np.sin(2 * np.pi * 330 * t) * 0.3
    sig[SR * 6:SR * 11] = 0.0
    sig += rng.standard_normal(sig.size) * 0.02
    return (np.clip(sig, -1, 1) * 32767.0).round().astype(np.int16)


def test_int16_pcm_equals_float32_and_jax(pair):
    """int16 PCM rides int16 to the device and gives the f32 path's result
    exactly, and JAX's int16 result."""
    jax_model, port_model = pair
    pcm = _pcm()
    kw = dict(language='en', temperature=0, verbose=None, batch_size=2)
    r16 = port_model.transcribe_batched(pcm, **kw)
    r32 = port_model.transcribe_batched(pcm.astype(np.float32) / 32768.0, **kw)
    assert r16.to_dict() == r32.to_dict()
    _assert_same(r16, jax_model.transcribe_batched(pcm, **kw))


def test_encoder_runs_once_a_group_across_the_ladder(pair, long_audio, monkeypatch):
    """compression_ratio_threshold=-1 fails every window on every rung, so
    the whole ladder re-decodes every window; the encoder still runs once
    a group, and never outside ``embed_audio`` (JAX's
    test_batched_encodes_once_across_full_fallback_ladder)."""
    import stable_ts_tpu_torch.models.whisper.decoding as D
    import stable_ts_tpu_torch.models.whisper.timing as T
    from stable_ts_tpu_torch.loaders import WhisperTorch
    _, port_model = pair
    calls, rungs = [], []
    real_embed, real_decode = WhisperTorch.embed_audio, WhisperTorch.decode

    def boom(*a, **kw):
        raise AssertionError('encoder ran outside the one-per-group pass')

    monkeypatch.setattr(D, 'encoder_apply', boom)
    monkeypatch.setattr(T, 'encoder_apply', boom)
    monkeypatch.setattr(WhisperTorch, 'embed_audio',
                        lambda self, mel: calls.append(1) or real_embed(self, mel))
    monkeypatch.setattr(WhisperTorch, 'decode', lambda self, feats, options, **kw:
                        rungs.append(options.temperature) or
                        real_decode(self, feats, options, **kw))
    result = port_model.transcribe_batched(
        long_audio, verbose=None, batch_size=2, language='en',
        temperature=(0.0, 0.2, 0.4), compression_ratio_threshold=-1.0)
    assert result is not None
    assert sum(calls) == 2          # three windows in groups of two
    assert rungs == [0.2, 0.4, 0.2, 0.4]


def test_retry_rows_are_bucketed_to_powers_of_two(pair, long_audio, monkeypatch):
    """Only the failed windows re-decode, padded to the next power of two:
    three failing windows of a group of eight take a 4-row retry."""
    from stable_ts_tpu_torch.loaders import WhisperTorch
    _, port_model = pair
    rows = []
    real_decode = WhisperTorch.decode
    monkeypatch.setattr(WhisperTorch, 'decode', lambda self, feats, options, **kw:
                        rows.append(feats.shape[0]) or
                        real_decode(self, feats, options, **kw))
    port_model.transcribe_batched(long_audio, verbose=None, batch_size=8,
                                  language='en', temperature=(0.0, 0.5),
                                  compression_ratio_threshold=-1.0)
    assert rows == [4]


def test_progress_is_monotone_and_fractional(pair, long_audio):
    _, port_model = pair
    calls = []
    port_model.transcribe_batched(
        long_audio, verbose=None, batch_size=2, language='en', temperature=0,
        progress_callback=lambda cur, total: calls.append((cur, total)))
    curs = [c for c, _ in calls]
    assert len(calls) >= 2 and curs == sorted(curs)
    total = calls[-1][1]
    assert total == pytest.approx(70.0, abs=0.5)
    assert calls[-1][0] == pytest.approx(total, abs=1e-6)
    assert any(c < total - 1.0 for c in curs), curs


@pytest.mark.parametrize('verbose,shown', [(False, True), (None, False)],
                         ids=['verbose_false_shows', 'verbose_none_silent'])
def test_progress_bar_follows_verbose(pair, verbose, shown, capfd):
    _, port_model = pair
    port_model.transcribe_batched(_noise(35, seed=0), language='en',
                                  temperature=0, verbose=verbose)
    err = capfd.readouterr().err
    assert ('Transcribe' in err and '%|' in err) == shown


def test_options_are_checked_as_jax_checks_them(pair):
    """Unknown keyword arguments raise TypeError; deprecated ones warn;
    extra_models raises NotImplementedError with JAX's message."""
    jax_model, port_model = pair
    audio = _noise(5, seed=1)
    with pytest.raises(TypeError, match='unsupported keyword'):
        port_model.transcribe_batched(audio, verbose=None,
                                      definitely_not_an_option=1)
    with pytest.raises(TypeError, match='either prompt= or initial_prompt='):
        port_model.transcribe_batched(audio, verbose=None, prompt='a',
                                      initial_prompt='b')
    with pytest.warns(UserWarning, match='deprecated'):
        port_model.transcribe_batched(audio, verbose=None, language='en',
                                      temperature=0, mel_first=False,
                                      time_scale=2.0)
    messages = []
    for model in (port_model, jax_model):
        with pytest.raises(NotImplementedError) as err:
            model.transcribe_batched(audio, verbose=None, language='en',
                                     extra_models=[model])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_beam_batch_is_scaled_as_jax_scales_it(pair, monkeypatch):
    """windows x beams stay within 128 rows: beam 40 at batch 8 -> 3."""
    from stable_ts_tpu_torch.loaders import WhisperTorch
    _, port_model = pair
    seen = []
    real = WhisperTorch.decode_launch
    monkeypatch.setattr(WhisperTorch, 'decode_launch', lambda self, feats, options, **kw:
                        seen.append(feats.shape[0]) or real(self, feats, options, **kw))
    with pytest.warns(UserWarning, match='window batch scaled 8 -> 3'):
        port_model.transcribe_batched(_noise(5, seed=1), verbose=None,
                                      language='en', temperature=0,
                                      beam_size=40, sample_len=4)
    assert seen == [3]


def test_group_sized_reads_and_loader_equals_array(pair, long_audio, tmp_path,
                                                   monkeypatch):
    """The driver pulls window-sized chunks from an AudioLoader (bounded
    memory) and a file through the loader gives the array's result."""
    from stable_ts_tpu_torch.audio.loader import AudioLoader
    from stable_ts_tpu_torch.audio.output import save_audio
    _, port_model = pair
    path = save_audio(long_audio, str(tmp_path / 'long.wav'))
    kw = dict(verbose=None, batch_size=2, language='en', temperature=0)
    sizes = []
    real = AudioLoader.next_valid_chunk

    def spy(self, seek, size=None):
        sizes.append(size)
        return real(self, seek, size)

    monkeypatch.setattr(AudioLoader, 'next_valid_chunk', spy)
    loader = AudioLoader(path, stream=True)
    assert loader.stream
    streamed = port_model.transcribe_batched(loader, **kw)
    assert len(streamed) > 0 and streamed[-1].end <= 70.5
    assert sizes and all(s == 480000 for s in sizes)
    monkeypatch.undo()
    assert port_model.transcribe_batched(path, **kw).text == \
        port_model.transcribe_batched(long_audio, **kw).text == streamed.text


def _fake_oom():
    return torch.OutOfMemoryError('CUDA out of memory. Tried to allocate 7.90 GiB')


def test_oom_halves_the_batch_and_drops_the_failed_attempt(pair, monkeypatch):
    """8 -> OOM -> 4 -> OOM -> 2 completes (35 s: one group of two
    windows), with both warnings; when each retry starts, the failed
    attempts' features are no longer referenced."""
    from stable_ts_tpu_torch.batched import transcribe_batched
    _, port_model = pair
    audio = _noise(35, seed=0)
    seen, alive = [], []
    feature_refs = []
    real = port_model.decode_launch

    def flaky(features, options, **kw):
        alive.append([r() is not None for r in feature_refs])
        seen.append(int(features.shape[0]))
        if features.shape[0] > 2:
            feature_refs.append(weakref.ref(features))
            raise _fake_oom()
        return real(features, options, **kw)

    monkeypatch.setattr(port_model, 'decode_launch', flaky)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        result = transcribe_batched(port_model, audio, batch_size=8,
                                    language='en', temperature=0, verbose=None)
    assert result.has_words
    assert seen == [8, 4, 2]
    assert alive == [[], [False], [False, False]]
    msgs = [str(w.message) for w in caught]
    assert any('retrying transcription with batch_size=4' in m for m in msgs)
    assert any('retrying transcription with batch_size=2' in m for m in msgs)


def test_non_oom_errors_propagate_and_oom_at_batch_one_reraises(pair, monkeypatch):
    from stable_ts_tpu_torch.batched import transcribe_batched
    _, port_model = pair
    audio = _noise(35, seed=0)
    tries = []

    def broken(features, options, **kw):
        tries.append(features.shape[0])
        raise ValueError('unrelated failure')

    monkeypatch.setattr(port_model, 'decode_launch', broken)
    with pytest.raises(ValueError, match='unrelated failure'):
        transcribe_batched(port_model, audio, batch_size=4, language='en',
                           verbose=None)
    assert tries == [4]

    def always_oom(features, options, **kw):
        tries.append(features.shape[0])
        raise _fake_oom()

    monkeypatch.setattr(port_model, 'decode_launch', always_oom)
    with pytest.raises(torch.OutOfMemoryError):
        transcribe_batched(port_model, audio, batch_size=2, language='en',
                           verbose=None)
    assert tries == [4, 2, 1]


def test_cap_warns_and_degrades(pair, monkeypatch):
    import stable_ts_tpu_torch.batched as bm
    _, port_model = pair
    monkeypatch.setattr(bm, '_hbm_batch_cap', lambda model, beam=1: 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        result = bm.transcribe_batched(port_model, _noise(20, seed=0),
                                       batch_size=16, language='en',
                                       temperature=0, verbose=None)
    assert result is not None
    assert any('exceeds the estimated device memory capacity of 2' in str(w.message)
               for w in caught)


def test_cpu_model_and_no_model_are_uncapped(pair):
    from stable_ts_tpu_torch.batched import _hbm_batch_cap
    _, port_model = pair
    assert _hbm_batch_cap(port_model) is None
    assert _hbm_batch_cap(object()) is None


def test_cap_reads_the_card_memory(monkeypatch):
    """large-v3 on a faked card: 70 GiB free and 3 GiB cached but unused.
    A window holds 32 x 1500 x 1280 x 2 bytes of int8 cross K/V
    (122,880,000), 32 x 256 x 1284 x 2 of self cache a beam (21,037,056),
    1500 x 1280 x 4 of features for two groups (7,680,000) and
    8 x 448 x 1500 x 2 of capture (10,752,000): 162,349,056 bytes, 246,497,280
    with beam 5. The budget is 70 + 3 - 2 GiB = 76,235,669,504 bytes: 469
    windows, 309 with beam 5."""
    import types
    from stable_ts_tpu_torch.batched import _hbm_batch_cap
    from stable_ts_tpu_torch.models.whisper.dims import (OPENAI_MODEL_DIMS,
                                                         ModelDimensions)
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda device=None: (70 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, 'memory_reserved', lambda device=None: 10 * gib)
    monkeypatch.setattr(torch.cuda, 'memory_allocated', lambda device=None: 7 * gib)
    model = types.SimpleNamespace(dims=ModelDimensions(**OPENAI_MODEL_DIMS['large-v3']),
                                  device=torch.device('cuda', 0))
    assert _hbm_batch_cap(model) == 76235669504 // 162349056 == 469
    assert _hbm_batch_cap(model, beam=5) == 76235669504 // 246497280 == 309


def _three_window_features(jax_model):
    import jax.numpy as jnp
    from stable_ts_tpu.ops.mel import log_mel_spectrogram
    audio = _noise(90, seed=4)
    mels = np.stack([np.asarray(log_mel_spectrogram(audio[i * 480000:(i + 1) * 480000]))
                     [..., :3000] for i in range(3)])
    return np.asarray(jax_model.embed_audio(jnp.asarray(mels)))


@pytest.mark.parametrize('strategy', ['greedy', 'beam'])
def test_decode_launch_collect_matches_jax(pair, strategy):
    """Three windows' features through ``decode_collect(decode_launch(...))``:
    JAX's tokens, avg_logprob and no-speech probability; with_features
    keeps each window's features, or leaves them out."""
    from stable_ts_tpu.models.whisper.decoding import DecodingOptions as JaxOptions
    from stable_ts_tpu_torch.models.whisper.decoding import DecodingOptions
    jax_model, port_model = pair
    feats = _three_window_features(jax_model)
    opts = dict(language='en', temperature=0.0, sample_len=24)
    if strategy == 'beam':
        opts.update(beam_size=2)
    ref = jax_model.decode(feats, JaxOptions(**opts))
    pending = port_model.decode_launch(torch.from_numpy(feats.copy()),
                                       DecodingOptions(**opts))
    assert pending.kind == ('beam' if strategy == 'beam' else 'sample')
    got = port_model.decode_collect(pending)
    assert len(got) == len(ref) == 3
    for g, r, f in zip(got, ref, feats):
        assert g.tokens == r.tokens and g.text == r.text
        assert g.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-5)
        assert g.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)
        assert np.array_equal(g.audio_features.numpy(), f)
    bare = port_model.decode_collect(pending, with_features=False)
    assert [b.tokens for b in bare] == [g.tokens for g in got]
    assert all(b.audio_features is None for b in bare)


def test_decode_collect_best_of_selects_as_jax(pair):
    """best_of: the port's sampled candidates (3 windows x 3) collected by
    the port and, laid into JAX's token buffer, by JAX's decode_collect:
    the same winner, tokens and avg_logprob per window."""
    import jax.numpy as jnp
    from stable_ts_tpu.models.whisper.decoding import (
        DecodingOptions as JaxOptions, PendingDecode as JaxPending,
        decode_collect as jax_collect)
    from stable_ts_tpu_torch.models.whisper.decoding import DecodingOptions
    jax_model, port_model = pair
    feats = _three_window_features(jax_model)
    opts = dict(language='en', temperature=0.7, best_of=3, sample_len=16)
    pending = port_model.decode_launch(torch.from_numpy(feats.copy()),
                                       DecodingOptions(**opts))
    got = port_model.decode_collect(pending, with_features=False)
    tokens, sums = (t.numpy() for t in pending.outputs)
    tokenizer = jax_model.get_tokenizer(language='en', task='transcribe')
    sample_begin = len(tokenizer.sot_sequence)
    buf = np.zeros((9, jax_model.dims.n_text_ctx), np.int32)
    buf[:, sample_begin:sample_begin + tokens.shape[1]] = tokens
    buf[:, sample_begin + tokens.shape[1]:] = tokenizer.eot
    ref = jax_collect(JaxPending(
        kind='sample', xa=None, batch=3, n_group=3, options=JaxOptions(**opts),
        tokenizer=tokenizer, sample_begin=sample_begin, sample_len=16,
        no_speech_probs=jnp.asarray(pending.no_speech_probs.numpy()),
        outputs=(jnp.asarray(buf), jnp.asarray(sums))), with_features=False)
    for g, r in zip(got, ref):
        assert g.tokens == r.tokens
        assert g.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-6)
        assert g.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-6)
