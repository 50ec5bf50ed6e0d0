"""The port's whole slice against stable_ts_tpu on the CPU: the same tiny
model (weights converted with ``from_jax``) transcribes the same seeded
40 s of audio through ``.transcribe(language='en', temperature=0)``.

JAX runs as its tests do off the TPU: the cross-attention decode kernel in
interpret mode (STABLE_TS_TPU_CROSS=interpret) and the int8 self cache
(STABLE_TS_TPU_SELFKV=1) through its XLA path, the port's configuration,
with its greedy logit epilogue off (the unfused filter chain) and in
interpret mode (STABLE_TS_TPU_EPI); the port's greedy loop always takes
the epilogue. Text and word-level SRT bytes must be equal, and every
word's start and end within 0.021 s (one 20 ms frame plus rounding)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
HEADS = [(0, 1), (1, 0), (1, 1)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _audio(seconds=40, seed=21):
    return (np.random.default_rng(seed).standard_normal(16000 * seconds)
            * 0.1).astype(np.float32)


@pytest.mark.parametrize('epilogue', ['0', 'interpret'], ids=['epi_off', 'epi_interpret'])
@pytest.mark.parametrize('kv_quant', [None, True], ids=['auto_float_kv', 'int8_kv'])
def test_transcribe_matches_jax(kv_quant, epilogue, monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', epilogue)
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    port_model = from_jax(jax_model, device='cpu')
    audio = _audio()
    kw = dict(language='en', temperature=0, verbose=None, kv_quant=kv_quant)
    ref = jax_model.transcribe(audio, **kw)
    got = port_model.transcribe(audio, **kw)
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    words_r = [w for s in ref.segments for w in s.words]
    words_g = [w for s in got.segments for w in s.words]
    assert len(words_g) == len(words_r) > 0
    for a, b in zip(words_g, words_r):
        assert a.word == b.word
        assert abs(a.start - b.start) <= 0.021 and abs(a.end - b.end) <= 0.021


def test_fresh_interpreter_never_imports_jax(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import stable_ts_tpu_torch
        from stable_ts_tpu_torch import load_test_model
        audio = (np.random.default_rng(1).standard_normal(16000 * 8) * 0.1
                 ).astype(np.float32)
        model = load_test_model(seed=0, alignment_heads={HEADS!r})
        result = model.transcribe(audio, language='en', temperature=0,
                                  verbose=None)
        srt = result.to_srt_vtt(word_level=True)
        assert isinstance(srt, str)
        for kw in (dict(temperature=(0, 0.5), best_of=2, logprob_threshold=100),
                   dict(temperature=0, beam_size=2)):
            assert model.transcribe(audio, language='en', verbose=None,
                                    **kw).segments
        assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
        assert 'stable_ts_tpu.models.whisper.model' not in sys.modules
        print('NO_JAX_OK')
    """)
    env = dict(os.environ, OMP_NUM_THREADS='2')
    proc = subprocess.run([sys.executable, '-c', script], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'NO_JAX_OK' in proc.stdout


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: asking for cuda is legitimate here')
    from stable_ts_tpu_torch.loaders import WhisperTorch, load_test_model
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    from stable_ts_tpu_torch.models.whisper.model import init_params
    with pytest.raises(RuntimeError, match='CUDA'):
        load_test_model(device='cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        init_params(tiny_test_dims(), device='cuda')
    cpu_params = init_params(tiny_test_dims())
    with pytest.raises(RuntimeError, match='CUDA'):
        WhisperTorch(tiny_test_dims(), cpu_params, device='cuda')


@pytest.mark.parametrize('options', [dict(kv_quant=4)], ids=['int4_kv'])
def test_unported_decoding_options_raise(options):
    from stable_ts_tpu_torch.loaders import load_test_model
    model = load_test_model(seed=0)
    mel = torch.zeros((80, 3000))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        model.decode(mel, language='en', **options)


def test_multilingual_without_language_detects_it():
    """A multilingual model given no language detects it (the 50257-entry
    synthetic rank table puts the special tokens where Whisper has them)."""
    import dataclasses
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    from stable_ts_tpu_torch.models.whisper.model import init_params
    dims = dataclasses.replace(tiny_test_dims(), n_vocab=51865)
    ranks = {bytes([b]): b for b in range(256)}
    ranks.update({b'\x00' + i.to_bytes(3, 'big'): i for i in range(256, 50257)})
    model = WhisperTorch(dims, init_params(dims), device='cpu', ranks=ranks)
    mel = torch.zeros((80, 3000))
    (code,), probs = model.detect_language(mel)
    assert code in probs[0] and probs[0][code] == max(probs[0].values())
    (result,) = model.decode(mel, sample_len=4)
    assert result.language == code
