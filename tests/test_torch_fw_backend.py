"""The port's faster-whisper backend (stable_ts_tpu_torch/backends/), with
stable_ts_tpu's own cases (tests/test_fw_backend.py) on a fake
faster_whisper module: the real CTranslate2 model is not installed.

Loader wiring, the stabilized transcribe (and its batched-pipeline route),
and align / align_words / refine running the engine-agnostic Aligner and
Refiner on the backend's inference functions. ``locate`` refuses such a
model, as stable_ts_tpu has no faster-whisper branch for it. One parity
case runs the same fake model through both packages' transcribe, align,
align_words and refine: the SRT bytes are equal.
"""
import sys
import types
from collections import namedtuple

import numpy as np
import pytest

SR = 16000

FwWord = namedtuple('FwWord', 'start end word probability')
FwSegment = namedtuple(
    'FwSegment', 'id seek start end text tokens temperature avg_logprob '
                 'compression_ratio no_speech_prob words')
FwInfo = namedtuple('FwInfo', 'language language_probability duration')

_WORDS = [(' hello', 0.5, 0.9), (' world.', 1.0, 1.5),
          (' second', 3.0, 3.5), (' segment.', 3.6, 4.2)]


def _encode(text):
    return [256 + b for b in text.encode()]


def _fake_segments():
    segs, words = [], []
    for w, s, e in _WORDS:
        words.append(FwWord(s, e, w, 0.9))
        if w.endswith('.'):
            segs.append(FwSegment(
                id=len(segs), seek=0, start=words[0].start, end=words[-1].end,
                text=''.join(x.word for x in words),
                tokens=[t for x in words for t in _encode(x.word)],
                temperature=0.0, avg_logprob=-0.2, compression_ratio=1.1,
                no_speech_prob=0.01, words=words))
            words = []
    return segs


class _FakeCT2Core:
    """Stands in for the ctranslate2.models.Whisper core."""
    is_multilingual = True

    def align(self, encoder_output, sot_sequence, token_lists, num_frames,
              median_filter_width=1):
        Out = namedtuple('AlignOut', 'text_token_probs')
        # probability rises with the unmuted fraction of the encoded audio
        frac = float(encoder_output)
        return [Out([min(0.95, 0.25 + 0.7 * frac)] * len(toks))
                for toks in token_lists]


class _FakeFeatureExtractor:
    sampling_rate = SR
    hop_length = 160
    nb_max_frames = 3000

    def __call__(self, audio):
        # "features" = the unmuted fraction, smuggled through a 2-D array
        # (adapter only slices axis 1)
        audio = np.asarray(audio)
        frac = float((np.abs(audio) > 1e-8).mean())
        return np.full((1, 8), frac, np.float32)


class _FakeWhisperModel:
    def __init__(self, model_size_or_path, **options):
        self.init_options = options
        self.feature_extractor = _FakeFeatureExtractor()
        self.model = _FakeCT2Core()
        self.hf_tokenizer = object()
        self.transcribe_calls = []

    def transcribe(self, audio, **options):
        self.transcribe_calls.append(('plain', options))
        return iter(_fake_segments()), FwInfo('en', 0.99, 5.0)

    def encode(self, features):
        return float(np.asarray(features)[0, 0])

    def add_word_timestamps(self, segments, tokenizer, encoder_output,
                            num_frames, prepend_punctuations,
                            append_punctuations, last_speech_timestamp):
        seg = segments[0][0]
        toks = seg['tokens']
        dur = seg['end'] - seg['start']
        # uniform spread over the segment; word split = adapter's token split
        n = max(len(toks), 1)
        words, i = [], 0
        text = bytes(t - 256 for t in toks).decode(errors='replace')
        parts = [' ' + p for p in text.split(' ') if p] or [text]
        step = dur / max(len(parts), 1)
        for j, part in enumerate(parts):
            words.append(dict(word=part, start=round(seg['start'] + j * step, 3),
                              end=round(seg['start'] + (j + 1) * step, 3),
                              probability=0.9,
                              tokens=_encode(part)))
        seg['words'] = words


class _FakeBatchedPipeline:
    def __init__(self, model):
        self.model = model

    def transcribe(self, audio, **options):
        self.model.transcribe_calls.append(('batched', options))
        return iter(_fake_segments()), FwInfo('en', 0.99, 5.0)


class _FakeTokenizer:
    def __init__(self, hf_tokenizer, multilingual, task='transcribe',
                 language=None):
        self.language_code = language or 'en'
        self.task = task
        self.eot = 50257
        self.no_timestamps = 50363
        self.timestamp_begin = 50364
        self.sot_sequence = (50258, 50259, 50359)

    def encode(self, text):
        return _encode(text)

    def decode(self, tokens):
        return bytes(t - 256 for t in tokens if 256 <= t < 50257).decode(
            errors='replace')


@pytest.fixture()
def fake_fw(monkeypatch):
    mod = types.ModuleType('faster_whisper')
    mod.WhisperModel = _FakeWhisperModel
    mod.BatchedInferencePipeline = _FakeBatchedPipeline
    tok_mod = types.ModuleType('faster_whisper.tokenizer')
    tok_mod.Tokenizer = _FakeTokenizer
    mod.tokenizer = tok_mod
    monkeypatch.setitem(sys.modules, 'faster_whisper', mod)
    monkeypatch.setitem(sys.modules, 'faster_whisper.tokenizer', tok_mod)
    return mod


@pytest.fixture()
def audio():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(SR * 5) * 0.1).astype(np.float32)


class TestLoader:
    def test_import_error_without_package(self):
        sys.modules.pop('faster_whisper', None)
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        with pytest.raises(ImportError, match='faster-whisper'):
            load_faster_whisper('tiny')

    def test_wiring(self, fake_fw):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny', device='cpu')
        assert m.init_options == {'device': 'cpu'}
        assert m.model_size_or_path == 'tiny'
        assert callable(m.transcribe_original)
        assert m.batch_inference_pipeline is not None
        for meth in ('transcribe', 'align', 'align_words', 'refine'):
            assert callable(getattr(m, meth))

    def test_transcribe_stable_deprecated(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        with pytest.warns(UserWarning, match='deprecated'):
            r = m.transcribe_stable(audio, verbose=None)
        assert r.text


class TestTranscribe:
    def test_stabilized_result(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        r = m.transcribe(audio, verbose=None)
        assert 'hello' in r.text and 'segment' in r.text
        words = [w for s in r.segments for w in s.words]
        assert words and all(w.end >= w.start for w in words)
        assert m.transcribe_calls[0][0] == 'plain'

    def test_batch_size_routes_to_pipeline(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        m.transcribe(audio, verbose=None, batch_size=8)
        kind, opts = m.transcribe_calls[0]
        assert kind == 'batched'
        assert opts['batch_size'] == 8

    def test_progress_callback_monotone(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        seen = []
        m.transcribe(audio, verbose=None,
                     progress_callback=lambda cur, total: seen.append((cur, total)))
        assert seen and seen == sorted(seen)
        assert seen[-1][0] == seen[-1][1]


class TestAlignRefine:
    def test_align_plain_text(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        r = m.align(audio, ' hello world goodbye', language='en')
        assert r is not None and r.has_words
        words = [w.word.strip() for s in r.segments for w in s.words]
        assert 'hello' in ' '.join(words)

    def test_refine_moves_timestamps(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        base = m.transcribe(audio, verbose=None)
        before = [(w.start, w.end) for w in base.all_words()]
        refined = m.refine(audio, base, inplace=False, steps='s')
        after = [(w.start, w.end) for w in refined.all_words()]
        assert len(before) == len(after)
        assert all(e >= s for s, e in after)


class TestModifyModel:
    """Public modify_model (loaders.py), the reference's
    original_whisper.py:931."""

    def test_whisper_torch_passthrough(self):
        from stable_ts_tpu_torch.loaders import load_test_model, modify_model
        m = load_test_model(device='cpu')
        assert modify_model(m) is m

    def test_fw_model_patched(self, fake_fw):
        from stable_ts_tpu_torch.loaders import modify_model
        raw = fake_fw.WhisperModel('tiny')
        patched = modify_model(raw)
        assert patched is raw
        assert callable(raw.transcribe_original)
        for meth in ('transcribe', 'align', 'align_words', 'refine'):
            assert callable(getattr(raw, meth))

    def test_unknown_object_rejected(self):
        from stable_ts_tpu_torch.loaders import modify_model
        with pytest.raises(TypeError, match='transcribe_any'):
            modify_model(object())


class TestAlignWordsAndLocate:
    def test_align_words_runs_sequentially(self, fake_fw, audio):
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        segs = [dict(start=0.0, end=2.0, text=' hello world.'),
                dict(start=2.5, end=4.5, text=' second segment.')]
        r = m.align_words(audio, segs, language='en', parallel=True)
        assert [w.word.strip() for w in r.all_words()] == [
            'hello', 'world.', 'second', 'segment.']
        assert all(s.start <= w.start <= w.end <= s.end + 1e-6
                   for s in r.segments for w in s.words)

    def test_locate_refuses(self, fake_fw, audio):
        from stable_ts_tpu_torch.alignment import locate
        from stable_ts_tpu_torch.loaders import load_faster_whisper
        m = load_faster_whisper('tiny')
        assert not hasattr(m, 'locate')
        with pytest.raises(NotImplementedError, match='faster-whisper'):
            locate(m, audio, ' hello', language='en')


def test_same_fake_model_gives_jax_results(fake_fw, audio):
    """The one fake model through stable_ts_tpu's and the port's backend:
    transcribe, then align of its text, align_words of its segments and
    refine of the result give the same SRT bytes in both packages."""
    from stable_ts_tpu.loaders import load_faster_whisper as load_jax
    from stable_ts_tpu_torch.loaders import load_faster_whisper as load_port
    ref_model, got_model = load_jax('tiny'), load_port('tiny')

    def srt(result):
        return result.to_srt_vtt(word_level=True)

    ref, got = (m.transcribe(audio, verbose=None) for m in (ref_model, got_model))
    assert srt(got) == srt(ref) and ref.has_words
    text = ref.text
    assert srt(got_model.align(audio, text, language='en')) == srt(
        ref_model.align(audio, text, language='en'))
    segs = [dict(start=s.start, end=s.end, text=s.text) for s in ref.segments]
    assert srt(got_model.align_words(audio, [dict(s) for s in segs], language='en')) == srt(
        ref_model.align_words(audio, [dict(s) for s in segs], language='en'))
    refined = [m.refine(audio, r, inplace=False, steps='s')
               for m, r in ((ref_model, ref), (got_model, got))]
    assert srt(refined[1]) == srt(refined[0])
