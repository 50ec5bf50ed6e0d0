"""Dynamic alignment heads in the port against stable_ts_tpu on the CPU.

A model with no known alignment heads selects 6 heads per token by their
attention peaks (the reference's fallback); ``dynamic_heads`` asks for it
with any model, as an int or as 'count,iterations' (each pass after the
first scores the heads against the midpoints of the previous pass's DTW
jumps). The same tiny model (``from_jax`` of JAX's ``load_test_model()``,
which knows no heads) transcribes the same seeded noise through both
packages, JAX with its greedy logit epilogue off: text, word-level SRT
bytes and every word's start and end must be equal. The head selection's
host code is the port's own copy and must equal JAX's exactly."""
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


@pytest.mark.parametrize('options', [dict(aligner='new'), dict(aligner={'topk': 4}),
                                     dict(extra_models=['another model'])],
                         ids=['new_aligner', 'new_aligner_dict', 'extra_models'])
def test_unported_alignment_options_raise(options):
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        model.transcribe(_audio(4), language='en', temperature=0, verbose=None,
                         **options)
