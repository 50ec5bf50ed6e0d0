"""Forced alignment in the port (``align``, ``align_words``, the
engine-agnostic ``Aligner``, ``Refiner`` and ``transcribe_any``) against
stable_ts_tpu on the CPU.

The tiny models are ``from_jax`` of JAX's ``load_test_model``: with the
alignment heads [(0, 1), (1, 0), (1, 1)] (the fused single-window pass and
the batched selective capture) and with none (dynamic heads, the full
capture). JAX runs as its own tests run it on the CPU. Words, tokens,
starts and ends must be equal, probabilities within 1e-6, SRT bytes
equal; on seeded noise and on JAX's 70-s tone fixture. In the port, the
fused window equals the unfused composition (as JAX's
``tests/test_fused_align.py`` pins it); ``align_words`` with and without
``parallel`` gives the same words in both packages; ``find_alignment``
takes a precomputed selected capture. The host code the port copies
(``Aligner``, ``Refiner``, ``transcribe_any``, ``result/repair.py``) gives
JAX's results on engine-free fakes."""
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]


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
    assert jax_model.alignment_heads is None
    return jax_model, from_jax(jax_model, device='cpu')


def _noise(seconds, seed=0):
    return (np.random.default_rng(seed).standard_normal(SR * seconds) * 0.3
            ).astype(np.float32)


def _tone():
    """70 s: 8 s of tone, 4 s of silence, six times (JAX's fixture)."""
    t = np.arange(SR * 8) / SR
    tone = (np.sin(2 * np.pi * 440 * t) * 0.4).astype(np.float32)
    return np.concatenate([tone, np.zeros(SR * 4, np.float32)] * 6)[:SR * 70]


TEXT = (' the quick brown fox jumps over the lazy dog and then it runs'
        ' back home again')
LONG_TEXT = ' ' + ' '.join(f'word{i}' for i in range(40))


def _words(result):
    return [(w.word, w.start, w.end, list(w.tokens))
            for s in result.segments for w in s.words]


def _assert_same(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _words(got) == _words(ref) and len(_words(got)) > 0
    assert ([w.probability for w in got.all_words()]
            == pytest.approx([w.probability for w in ref.all_words()], abs=1e-6))


# -- the fused single-window pass against the unfused composition, in the port --

def _word_tokens(tokenizer, text):
    from stable_ts_tpu_torch.non_whisper.alignment import WordToken
    return [WordToken(' ' + w, tokenizer.encode(' ' + w)) for w in text.split()]


def _unfused_func(model, tokenizer, monkeypatch):
    from stable_ts_tpu_torch import alignment
    from stable_ts_tpu_torch.options import AllOptions
    monkeypatch.setattr(alignment, '_legacy_known_heads', lambda *a: False)
    try:
        return alignment._whisper_alignment_func(
            model, tokenizer, AllOptions({}, vanilla_align=True))
    finally:
        monkeypatch.undo()


def _assert_word_dicts_equal(a, b):
    assert len(a) == len(b) > 0
    for wa, wb in zip(a, b):
        assert ({k: v for k, v in wa.items() if k != 'probability'}
                == {k: v for k, v in wb.items() if k != 'probability'})
        assert wa['probability'] == pytest.approx(wb['probability'], abs=1e-6)


@pytest.mark.parametrize('seconds,text', [
    (3, 'hello world how are you'),
    (1, 'hi'),                      # a short window: cropped frame columns
    (6, 'the quick brown fox jumps over the lazy dog again and again'),
])
def test_fused_matches_unfused(known, monkeypatch, seconds, text):
    from stable_ts_tpu_torch.alignment import _fused_single_window_func
    from stable_ts_tpu_torch.non_whisper.alignment import WordToken
    model = known[1]
    tokenizer = model.get_tokenizer(language='en', task='transcribe')
    audio = (np.random.default_rng(seconds).standard_normal(SR * seconds)
             * 0.3).astype(np.float32)
    wts = _word_tokens(tokenizer, text)
    fast = _fused_single_window_func(model, tokenizer)
    slow = _unfused_func(model, tokenizer, monkeypatch)
    _assert_word_dicts_equal(
        fast(audio, [WordToken(w.word, list(w.tokens)) for w in wts]),
        slow(audio, [WordToken(w.word, list(w.tokens)) for w in wts]))


def test_fused_handles_padding_word_tokens(known, monkeypatch):
    """A gap-padding WordToken mid-stream is timed like any word."""
    from stable_ts_tpu_torch.alignment import _fused_single_window_func
    from stable_ts_tpu_torch.non_whisper.alignment import WordToken
    model = known[1]
    tokenizer = model.get_tokenizer(language='en', task='transcribe')
    audio = (np.random.default_rng(7).standard_normal(SR * 4) * 0.3
             ).astype(np.float32)
    wts = _word_tokens(tokenizer, 'alpha beta gamma')
    wts = [wts[0], WordToken(' ...', tokenizer.encode(' ...'), True), *wts[1:]]
    fast = _fused_single_window_func(model, tokenizer)
    slow = _unfused_func(model, tokenizer, monkeypatch)

    def copy():
        return [WordToken(w.word, list(w.tokens), w.is_padding) for w in wts]
    _assert_word_dicts_equal(fast(audio, copy()), slow(audio, copy()))


def test_align_routes_through_the_fused_window(known, monkeypatch):
    from stable_ts_tpu_torch import alignment
    calls = []
    fused = alignment._fused_align_window

    def counting(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)
    monkeypatch.setattr(alignment, '_fused_align_window', counting)
    result = known[1].align(_noise(3), ' hello world how are you',
                            language='en', verbose=None)
    assert calls and result.has_words
    assert result.text == ' hello world how are you'


# -- align against JAX ---------------------------------------------------------------

def _whisper_results(segments):
    from stable_ts_tpu.result import WhisperResult as JaxResult
    from stable_ts_tpu_torch.result import WhisperResult
    return (JaxResult([dict(s) for s in segments]),
            WhisperResult([dict(s) for s in segments]))


@pytest.mark.parametrize('case', [
    'fused', 'dynamic_heads_3', 'new_aligner', 'no_heads', 'token_step',
    'original_split', 'whisper_result', 'failure_threshold'])
def test_align_matches_jax_on_noise(known, no_heads, case):
    """Each mode and option on 12 s of seeded noise."""
    jax_model, port_model = no_heads if case == 'no_heads' else known
    audio, text = _noise(12, seed=3), TEXT
    kw = dict(language='en', verbose=None)
    if case == 'dynamic_heads_3':
        kw.update(dynamic_heads=3)
    elif case == 'new_aligner':
        kw.update(aligner='new')
    elif case == 'token_step':
        text = LONG_TEXT
        kw.update(token_step=24)
    elif case == 'original_split':
        text = 'the quick brown fox\njumps over the lazy dog\nand runs back home'
        kw.update(original_split=True)
    elif case == 'failure_threshold':
        # forty words cannot fit in one second of audio
        audio, text = _noise(1, seed=5), LONG_TEXT
        kw.update(failure_threshold=0.1)
    if case == 'whisper_result':
        ref_text, got_text = _whisper_results([
            dict(start=0.0, end=5.0, text=' the quick brown fox'),
            dict(start=5.0, end=11.0, text=' jumps over the lazy dog')])
    else:
        ref_text = got_text = text
    with warnings.catch_warnings(record=True) as ref_warnings:
        warnings.simplefilter('always')
        ref = jax_model.align(audio, ref_text, **kw)
    with warnings.catch_warnings(record=True) as got_warnings:
        warnings.simplefilter('always')
        got = port_model.align(audio, got_text, **kw)
    _assert_same(got, ref)
    assert ([str(w.message) for w in got_warnings if w.category is UserWarning]
            == [str(w.message) for w in ref_warnings if w.category is UserWarning])


@pytest.mark.parametrize('mode', ['fused', 'new_aligner', 'no_heads'])
def test_align_matches_jax_on_the_tone_fixture(known, no_heads, mode):
    """JAX's 70-s tone fixture: six tone bursts between silences, three
    windows, the nonspeech skip between them. (``dynamic_heads=3`` runs on
    noise above: JAX's host head selection takes 80 s on this fixture.)"""
    jax_model, port_model = no_heads if mode == 'no_heads' else known
    kw = dict(language='en', verbose=None)
    if mode == 'new_aligner':
        kw.update(aligner='new')
    audio = _tone()
    _assert_same(port_model.align(audio, LONG_TEXT, **kw),
                 jax_model.align(audio, LONG_TEXT, **kw))


# -- align_words against JAX -----------------------------------------------------------

_NOISE_SEGMENTS = [dict(start=0.0, end=3.0, text=' hello world'),
                   dict(start=3.5, end=7.0, text=' this is a test'),
                   dict(start=7.5, end=11.0, text=' of alignment here')]
_TONE_SEGMENTS = [dict(start=12.0 * i, end=12.0 * i + 8.0,
                       text=' ' + ' '.join(f'w{i}{j}' for j in range(5)))
                  for i in range(6)]


@pytest.mark.parametrize('audio_name', ['noise', 'tone'])
@pytest.mark.parametrize('heads', ['known', 'no_heads'])
def test_align_words_matches_jax(known, no_heads, heads, audio_name):
    """parallel=True and parallel=False in both packages give the same
    words. On the model with no heads, parallel=True reaches
    ``add_word_timestamps(precomputed=...)`` with the full 4-D capture."""
    jax_model, port_model = known if heads == 'known' else no_heads
    if audio_name == 'noise':
        audio, segments = _noise(12, seed=6), _NOISE_SEGMENTS
    else:
        audio, segments = _tone(), _TONE_SEGMENTS
    kw = dict(language='en', verbose=None)
    ref = jax_model.align_words(audio, [dict(s) for s in segments],
                                parallel=False, **kw)
    for model in (jax_model, port_model):
        for parallel in (False, True):
            got = model.align_words(audio, [dict(s) for s in segments],
                                    parallel=parallel, **kw)
            _assert_same(got, ref)


def test_align_words_parallel_defaults_to_the_card(known, monkeypatch):
    """``parallel=None`` is on only for a model on a CUDA device."""
    from stable_ts_tpu_torch import alignment
    built = []
    batch_func = alignment._whisper_alignment_batch_func

    def spy(*args):
        built.append(1)
        return batch_func(*args)
    monkeypatch.setattr(alignment, '_whisper_alignment_batch_func', spy)
    port_model = known[1]
    assert port_model.align_words(_noise(12, seed=6),
                                  [dict(s) for s in _NOISE_SEGMENTS],
                                  language='en', verbose=None).has_words
    assert not built


def test_faster_whisper_models_are_refused():
    """locate alone: as in stable_ts_tpu, it has no faster-whisper branch
    (align, align_words and refine take such a model through the backend,
    tests/test_torch_fw_backend.py)."""
    from stable_ts_tpu_torch.alignment import locate

    class FakeFasterWhisper:
        model = object()
        feature_extractor = object()

    with pytest.raises(NotImplementedError, match='faster-whisper models have no locate'):
        locate(FakeFasterWhisper(), _noise(1), ' hello', language='en')


def test_package_exports():
    import stable_ts_tpu
    import stable_ts_tpu_torch
    from stable_ts_tpu_torch import alignment, non_whisper, options
    for name in ('align', 'align_words', 'refine', 'locate', 'AllOptions',
                 'transcribe_any', 'Aligner', 'Refiner'):
        assert name in stable_ts_tpu_torch.__all__
    assert stable_ts_tpu_torch.align is alignment.align
    assert stable_ts_tpu_torch.align_words is alignment.align_words
    assert stable_ts_tpu_torch.refine is alignment.refine
    assert stable_ts_tpu_torch.locate is alignment.locate
    assert alignment.__all__ == ['align', 'align_words', 'refine', 'locate']
    assert stable_ts_tpu_torch.AllOptions is options.AllOptions
    assert stable_ts_tpu_torch.transcribe_any is non_whisper.transcribe_any
    assert stable_ts_tpu_torch.Aligner is non_whisper.Aligner
    assert stable_ts_tpu_torch.Refiner is non_whisper.Refiner
    # every name stable_ts_tpu exports; the port's own entry points beside
    assert set(stable_ts_tpu.__all__) - set(stable_ts_tpu_torch.__all__) == set()
    from stable_ts_tpu_torch import loaders, video_output
    assert stable_ts_tpu_torch.load_faster_whisper is loaders.load_faster_whisper
    assert (stable_ts_tpu_torch.encode_video_comparison
            is video_output.encode_video_comparison)


# -- find_alignment with a precomputed capture --------------------------------------------

def _timing_inputs(model, seconds=4, text=' alpha beta gamma delta'):
    from stable_ts_tpu_torch.alignment import _pad_mel
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    from stable_ts_tpu_torch.constants import N_SAMPLES
    tokenizer = model.get_tokenizer(language='en', task='transcribe')
    audio = _noise(seconds, seed=11)
    mel = _pad_mel(log_mel_spectrogram(audio, model.dims.n_mels,
                                       padding=N_SAMPLES - audio.shape[-1]))
    return tokenizer, tokenizer.encode(text), mel, audio.shape[-1]


@pytest.mark.parametrize('capture', ['selected', 'full'])
def test_precomputed_capture_gives_the_selective_words(known, capture):
    """The heads' rows of a selective capture (3-D), or the full 4-D
    capture, handed to find_alignment give the words of its own selective
    pass."""
    from stable_ts_tpu_torch.models.whisper import timing
    model = known[1]
    tokenizer, text_tokens, mel, samples = _timing_inputs(model)
    kw = dict(alignment_heads=model.alignment_heads)
    ref = timing.find_alignment(model.params, model.dims, tokenizer,
                                text_tokens, mel, samples, **kw)
    table, slots = timing.build_head_capture_table(HEADS, model.dims.n_text_layer)
    qks, probs, _ = timing.compute_qks_and_probs(
        model.params, model.dims, tokenizer, text_tokens, mel=mel,
        capture_index=table if capture == 'selected' else None)
    if capture == 'selected':
        qks = timing.gather_captured_heads(qks, slots)
    assert qks.ndim == (3 if capture == 'selected' else 4)
    got = timing.find_alignment(model.params, model.dims, tokenizer,
                                text_tokens, None, samples,
                                precomputed=(qks.cpu(), probs), **kw)
    assert [(w.word, w.tokens, w.start, w.end) for w in got] \
        == [(w.word, w.tokens, w.start, w.end) for w in ref]
    assert [w.probability for w in got] == [w.probability for w in ref]


def test_precomputed_selected_capture_refuses_dynamic_heads(known):
    from stable_ts_tpu_torch.models.whisper import timing
    model = known[1]
    tokenizer, text_tokens, _, samples = _timing_inputs(model)
    n = len(tokenizer.sot_sequence) + len(text_tokens) + 2
    selected = torch.zeros((len(HEADS), n, 1500), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='known heads'):
        timing.find_alignment(model.params, model.dims, tokenizer, text_tokens,
                              None, samples, alignment_heads=HEADS,
                              dynamic_heads=3,
                              precomputed=(selected, [0.5] * len(text_tokens)))


# -- the copied host code on engine-free fakes -------------------------------------------

def byte_encode(text: str):
    return list(text.encode('utf-8'))


def byte_decode(tokens):
    return bytes(tokens).decode('utf-8', errors='replace')


def spread_inference_func(words_per_second: float = 2.0):
    """A fake backend: words spread evenly from t=0 in each segment."""
    def inference_func(audio_segment, word_tokens):
        dur = 1.0 / words_per_second
        out = []
        t = 0.0
        for wt in word_tokens:
            out.append(dict(word=wt.word, start=round(t, 3),
                            end=round(t + dur, 3), probability=0.9))
            t += dur
        return out
    return inference_func


def zero_dur(audio_segment, word_tokens):
    """A fake backend whose every word has zero duration: nothing aligns."""
    return [dict(word=wt.word, start=0.0, end=0.0, probability=0.0)
            for wt in word_tokens]


def _result_dict(result):
    return None if result is None else result.to_dict()


@pytest.mark.parametrize('case', [
    'basic', 'token_step', 'original_split', 'failure_at_eof',
    'remove_instant_words', 'align_words'])
def test_aligner_matches_jax_on_fakes(case):
    from stable_ts_tpu.non_whisper.alignment import Aligner as JaxAligner
    from stable_ts_tpu_torch import Aligner
    audio = _noise(30 if case == 'token_step' else 10)
    options = dict(suppress_silence=False, decode=byte_decode,
                   encode=byte_encode)
    inference, text = spread_inference_func(), ' one two three four five'
    if case == 'token_step':
        inference = spread_inference_func(4.0)
        text = ' ' + ' '.join(f'word{i}' for i in range(30))
        options.update(token_step=40)
    elif case == 'original_split':
        text = 'line one here\nline two there'
        options.update(original_split=True)
    elif case in ('failure_at_eof', 'remove_instant_words'):
        inference, text, audio = zero_dur, ' alpha beta', _noise(2)
        options.update(remove_instant_words=case == 'remove_instant_words')

    def run(aligner_cls, result_cls):
        aligner = aligner_cls(inference_func=inference, **options)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            if case == 'align_words':
                return aligner.align_words(audio, result_cls([
                    dict(start=0.0, end=2.0, text=' hello world'),
                    dict(start=3.0, end=5.0, text=' more text')]))
            return aligner.align(audio, text)
    from stable_ts_tpu.result import WhisperResult as JaxResult
    from stable_ts_tpu_torch.result import WhisperResult
    ref = run(JaxAligner, JaxResult)
    got = run(Aligner, WhisperResult)
    assert _result_dict(got) == _result_dict(ref)


def test_refiner_matches_jax_on_a_fake():
    """The fake probability model of JAX's test_aligner.py: a token is
    likely iff its word's true span [1.0, 2.0] is unmuted."""
    from stable_ts_tpu.non_whisper.refinement import Refiner as JaxRefiner
    from stable_ts_tpu.result import WhisperResult as JaxResult
    from stable_ts_tpu_torch import Refiner, WhisperResult

    def inference_func(audio_segment, tokens):
        probs = np.zeros((2, len(tokens)), np.float32)
        for row in range(2):
            alive = np.abs(audio_segment[row][SR:2 * SR]).sum() > 0
            probs[row, :] = 0.9 if alive else 0.05
        return probs

    audio = np.ones(SR * 4, np.float32) * 0.3
    words = [[dict(word=' word', start=0.2, end=2.0, probability=0.9,
                   tokens=[5])]]
    ref = JaxRefiner(inference_func=inference_func, word_level=True).refine(
        audio, JaxResult(words), steps='s')
    got = Refiner(inference_func=inference_func, word_level=True).refine(
        audio, WhisperResult(words), steps='s')
    assert got.to_dict() == ref.to_dict()
    assert got.all_words()[0].start > 0.2


@pytest.mark.parametrize('case', ['numpy', 'wav_file', 'silence', 'resample',
                                  'none_timestamps'])
def test_transcribe_any_matches_jax(case, tmp_path):
    from stable_ts_tpu.non_whisper.transcribe import transcribe_any as jax_any
    from stable_ts_tpu_torch import transcribe_any

    def fake_asr(audio, **kwargs):
        dur = (len(audio) if isinstance(audio, np.ndarray) else SR * 2) / SR
        return [dict(start=0.1, end=dur / 2, text=' hello'),
                dict(start=dur / 2, end=dur - 0.1, text=' world')]
    audio, asr = _noise(2), fake_asr
    kw = dict(input_sr=SR, audio_type='numpy', suppress_silence=False)
    if case == 'wav_file':
        from stable_ts_tpu_torch.audio.output import save_audio
        audio = save_audio(_noise(2), str(tmp_path / 'a.wav'))
        kw = dict(audio_type='str', suppress_silence=False)
    elif case == 'silence':
        t = np.arange(SR) / SR
        tone = (np.sin(2 * np.pi * 440 * t) * 0.5).astype(np.float32)
        audio = np.concatenate([np.zeros(SR, np.float32), tone])
        kw = dict(input_sr=SR, audio_type='numpy')

        def asr(audio, **kwargs):
            return [dict(start=0.0, end=2.0, text=' the tone',
                         words=[dict(word=' the', start=0.0, end=1.2),
                                dict(word=' tone', start=1.2, end=2.0)])]
    elif case == 'resample':
        audio = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
        kw.update(input_sr=8000, model_sr=16000)
    elif case == 'none_timestamps':
        audio = np.zeros(SR * 8, np.float32)
        kw.update(force_order=True, regroup=False, verbose=None)

        def asr(audio, **kwargs):
            return [dict(start=0.5, end=None, text=' a b c',
                         words=[dict(word=' a', start=0.5, end=None),
                                dict(word=' b', start=None, end=None),
                                dict(word=' c', start=3.0, end=3.5)])]
    ref = jax_any(asr, audio, **kw)
    got = transcribe_any(asr, audio, **kw)
    assert got.to_dict() == ref.to_dict() and got.text


def _random_parts(rng, n, none_rate=0.35):
    """The seeded fuzz of JAX's tests/test_none_ts_repair.py."""
    t = 0.0
    parts = []
    for i in range(n):
        dur = float(rng.uniform(0.1, 0.8))
        start, end = round(t, 3), round(t + dur, 3)
        t += dur + float(rng.uniform(0.0, 0.3))
        if rng.random() < none_rate:
            start = None
        if rng.random() < none_rate:
            end = None
        parts.append(dict(word=f' w{i}', start=start, end=end))
    return parts


@pytest.mark.parametrize('seed', range(25))
def test_repair_fuzz_matches_jax(seed):
    from stable_ts_tpu.result.repair import replace_none_ts as jax_repair
    from stable_ts_tpu_torch.result.repair import replace_none_ts
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    total = float(rng.uniform(5.0, 30.0)) if rng.random() < 0.5 else None
    parts = _random_parts(rng, n)
    ours = [dict(p) for p in parts]
    theirs = [dict(p) for p in parts]
    replace_none_ts(ours, total)
    jax_repair(theirs, total)
    assert ours == theirs


@pytest.mark.parametrize('pattern', [
    [(None, None)],
    [(None, 1.0), (None, None)],
    [(0.0, None), (None, None), (3.0, 4.0)],
    [(None, 0.0), (0.0, None)],               # falsy-zero timestamps
    [(0.5, 1.5), (None, None), (None, None)],
    [(None, None), (None, None), (None, None)],
])
def test_repair_edge_patterns_match_jax(pattern):
    from stable_ts_tpu.result.repair import (repair_result_timestamps as
                                             jax_repair_result)
    from stable_ts_tpu.result.repair import replace_none_ts as jax_repair
    from stable_ts_tpu_torch.result.repair import (repair_result_timestamps,
                                                   replace_none_ts)
    for total in (None, 10.0):
        parts = [dict(word=f' w{i}', start=s, end=e)
                 for i, (s, e) in enumerate(pattern)]
        ours, theirs = [dict(p) for p in parts], [dict(p) for p in parts]
        replace_none_ts(ours, total)
        jax_repair(theirs, total)
        assert ours == theirs
        segments = [dict(start=None, end=None, text=' x',
                         words=[dict(p) for p in parts])]
        ours, theirs = [dict(segments[0])], [dict(segments[0])]
        ours[0]['words'] = [dict(p) for p in parts]
        theirs[0]['words'] = [dict(p) for p in parts]
        assert (repair_result_timestamps(ours, total)
                == jax_repair_result(theirs, total))
        assert ours == theirs
