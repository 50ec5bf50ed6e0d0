"""The port's whole slice against stable_ts_tpu on the CPU: the same tiny
model (weights converted with ``from_jax``) transcribes the same seeded
40 s of audio through ``.transcribe(language='en', temperature=0)``.

JAX runs as its tests do off the TPU: the cross-attention decode kernel in
interpret mode (STABLE_TS_TPU_CROSS=interpret) and the int8 self cache
(STABLE_TS_TPU_SELFKV=1) through its XLA path, the port's configuration,
with its greedy logit epilogue off (the unfused filter chain) and in
interpret mode (STABLE_TS_TPU_EPI); the port's greedy loop always takes
the epilogue. Text and word-level SRT bytes must be equal, and every
word's start and end within 0.021 s (one 20 ms frame plus rounding). The
same holds for a ``dq`` model (int8 weights) on packed int4 cross K/V.
The transcribe options that change the seek loop, the prompt or the
decoding (the silence mask on greedy and beam steps, a prompt, resets,
skips, clips, resuming, no regrouping, the voice band, translation) give
equal text and SRT bytes too. A fresh interpreter that transcribes and
takes a train step with the port loads neither jax, nor optax, nor any
module of stable_ts_tpu; it also runs ``transcribe_batched``, writes a
checkpoint, loads it and transcribes with the 'new' aligner and with an
extra model, runs ``align``, ``align_words``, ``refine`` and ``locate``,
and runs the command line on a WAV and on its JSON. Importing the
port tunes the host allocator, as importing stable_ts_tpu does.
``transcribe_minimal`` gives JAX's text and SRT bytes, and
``STABLE_TS_TPU_PROFILE`` traces a request with ``torch.profiler``."""
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


def _gapped_audio():
    """40 s of seeded noise with two silent gaps, 8-12 s and 24-29 s."""
    audio = _audio(40)
    audio[8 * 16000:12 * 16000] = 0
    audio[24 * 16000:29 * 16000] = 0
    return audio


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


@pytest.mark.parametrize('epilogue', ['0', 'interpret'], ids=['epi_off', 'epi_interpret'])
def test_dq_int4_transcribe_matches_jax(epilogue, monkeypatch):
    """The quantized path: int8 weights (dq) through the weight-only matmul
    (JAX: its CPU ``astype`` product, the same function) and packed int4
    cross K/V. Text and word-level SRT bytes equal, word times within
    0.021 s."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', epilogue)
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS, dq=True)
    port_model = from_jax(jax_model, device='cpu')
    assert port_model.quantized
    audio = _audio()
    kw = dict(language='en', temperature=0, verbose=None, kv_quant=4)
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


@pytest.mark.parametrize('case,gapped,options', [
    ('suppress_ts_greedy', True, dict(suppress_ts_tokens=True)),
    ('suppress_ts_beam3', True, dict(suppress_ts_tokens=True, beam_size=3)),
    ('initial_prompt', False, dict(initial_prompt='Hello there, friend.')),
    ('no_condition', True, dict(condition_on_previous_text=False)),
    ('nonspeech_skip', True, dict(nonspeech_skip=2.0)),
    ('avg_prob_threshold', False, dict(avg_prob_threshold=0.5)),
    ('clip_timestamps', True, dict(clip_timestamps='3,15,20')),
    ('resume', False, None),
    ('regroup_false', False, dict(regroup=False)),
    ('only_voice_freq', False, dict(only_voice_freq=True)),
    ('translate', False, dict(task='translate')),
], ids=lambda v: v if isinstance(v, str) else '')
def test_transcribe_options_match_jax(case, gapped, options, monkeypatch, tmp_path):
    """Each option on the tiny model (known heads, JAX's epilogue off), on
    20 s of noise or on 40 s with two silent gaps: text and word-level SRT
    bytes equal. ``resume`` continues, less its last segment, a result that
    JAX wrote for the first 12 s."""
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    port_model = from_jax(jax_model, device='cpu')
    audio = _gapped_audio() if gapped else _audio(20)
    kw = dict(language='en', temperature=0, verbose=None)
    if case == 'resume':
        partial = jax_model.transcribe(audio[:12 * 16000], **kw)
        path = str(tmp_path / 'partial.json')
        partial.save_as_json(path)
        assert len(partial.segments) > 1
        options = dict(resume=path + '+')
    kw.update(options)
    ref = jax_model.transcribe(audio, **kw)
    got = port_model.transcribe(audio, **kw)
    assert got.text == ref.text and len(ref.segments) > 0
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)


def test_fresh_interpreter_never_imports_jax(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import stable_ts_tpu_torch
        from stable_ts_tpu_torch import load_test_model
        audio = (np.random.default_rng(1).standard_normal(16000 * 8) * 0.1
                 ).astype(np.float32)
        model = load_test_model(seed=0, device='cpu', alignment_heads={HEADS!r})
        result = model.transcribe(audio, language='en', temperature=0,
                                  verbose=None)
        srt = result.to_srt_vtt(word_level=True)
        assert isinstance(srt, str)
        assert model.transcribe_batched(audio, language='en', temperature=0,
                                        verbose=None, batch_size=2).segments
        for kw in (dict(temperature=(0, 0.5), best_of=2, logprob_threshold=100),
                   dict(temperature=0, beam_size=2)):
            assert model.transcribe(audio, language='en', verbose=None,
                                    **kw).segments
        dq = load_test_model(seed=0, device='cpu', alignment_heads={HEADS!r},
                             dq=True)
        assert dq.quantized
        for kw in (dict(temperature=0), dict(temperature=0, beam_size=2)):
            assert dq.transcribe(audio, language='en', verbose=None, kv_quant=4,
                                 **kw).segments
        from stable_ts_tpu_torch import make_train_step
        from stable_ts_tpu_torch.models.whisper.model import init_params
        init_opt_state, train_step = make_train_step(model.dims)
        params = init_params(model.dims, seed=0, device='cpu')
        opt = init_opt_state(params)
        rng = np.random.default_rng(2)
        loss = train_step(params, opt, rng.standard_normal((1, 80, 3000)),
                          rng.integers(0, model.dims.n_vocab, (1, 8)))
        assert np.isfinite(float(loss))
        from stable_ts_tpu_torch import load_model
        from stable_ts_tpu_torch.models.whisper.load import save_openai_checkpoint
        save_openai_checkpoint('tiny.pt', model.dims, model.params)
        loaded = load_model('tiny.pt', device='cpu', alignment_heads={HEADS!r})
        for kw in (dict(aligner='new'), dict(extra_models=[model])):
            assert loaded.transcribe(audio, language='en', temperature=0,
                                     verbose=None, **kw).segments
        aligned = model.align(audio, ' hello world how are you', language='en',
                              verbose=None)
        assert aligned.has_words
        segs = [dict(start=0.0, end=4.0, text=' hello world'),
                dict(start=4.0, end=8.0, text=' how are you')]
        for parallel in (False, True):
            assert model.align_words(audio, [dict(s) for s in segs],
                                     language='en', verbose=None,
                                     parallel=parallel).has_words
            assert model.refine(audio, aligned, inplace=False, verbose=None,
                                parallel=parallel).has_words
        for mode in (2, 1, 0):
            assert isinstance(model.locate(audio, ' hello', language='en',
                                           mode=mode, verbose=None,
                                           probability_threshold=0.0), list)
        import wave
        with wave.open('clip.wav', 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((audio * 32767).astype('<i2').tobytes())
        from stable_ts_tpu_torch.cli import cli
        cli(['clip.wav', '--model', 'tiny.pt', '--device', 'cpu', '--language', 'en',
             '-f', 'srt,json', '-y', '-v', '0'])
        cli(['clip.json', '-o', 'again.vtt', '-y', '-v', '0'])
        assert open('clip.srt').read() and open('again.vtt').read()
        assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
        assert 'optax' not in sys.modules
        old = sorted(m for m in sys.modules
                     if m == 'stable_ts_tpu' or m.startswith('stable_ts_tpu.'))
        assert not old, old
        print('NO_JAX_OK')
    """)
    env = dict(os.environ, OMP_NUM_THREADS='2')
    proc = subprocess.run([sys.executable, '-c', script], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'NO_JAX_OK' in proc.stdout


def test_import_tunes_the_host_allocator(tmp_path):
    """A fresh interpreter that imports the port looks up glibc's mallopt
    (seen through Python's audit hook on ctypes) and, with the threshold
    raised to 256 MB, a fresh 64 MB array comes from the heap, where glibc's
    default (at most 32 MB) would map it on its own; as importing
    stable_ts_tpu does."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        looked_up = []
        sys.addaudithook(lambda event, args: looked_up.append(args[1])
                         if event == 'ctypes.dlsym' else None)
        import stable_ts_tpu_torch
        import numpy as np
        assert 'mallopt' in looked_up, looked_up
        a = np.ones(64 << 20, np.uint8)
        heap = [line.split()[0] for line in open('/proc/self/maps')
                if line.rstrip().endswith('[heap]')]
        lo, hi = (int(x, 16) for x in heap[0].split('-'))
        assert lo <= a.ctypes.data < hi, (hex(a.ctypes.data), heap)
        print('TUNED_OK')
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith('MALLOC_')
           and k != 'STABLE_TS_TPU_NO_MALLOC_TUNE'}
    proc = subprocess.run([sys.executable, '-c', script], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'TUNED_OK' in proc.stdout


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
    cpu_params = init_params(tiny_test_dims(), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        WhisperTorch(tiny_test_dims(), cpu_params, device='cuda')


def test_entry_points_default_to_the_gpu(tmp_path):
    """load_test_model, from_jax, init_params, from_jax_params and
    load_model run on the card unless asked for the CPU: with no GPU and no
    ``device``, each raises."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is legitimate here')
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax, load_test_model
    from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    from stable_ts_tpu_torch.models.whisper.model import init_params
    jax_model = load_jax()
    from stable_ts_tpu_torch import load_model
    from stable_ts_tpu_torch.models.whisper.load import save_openai_checkpoint
    path = str(tmp_path / 'tiny.pt')
    save_openai_checkpoint(path, tiny_test_dims(),
                           init_params(tiny_test_dims(), device='cpu'))
    for call in (load_test_model, lambda: from_jax(jax_model),
                 lambda: init_params(tiny_test_dims()),
                 lambda: from_jax_params(jax_model.params, tiny_test_dims()),
                 lambda: load_model(path)):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()


@pytest.mark.parametrize('options', [dict(kv_quant=4)], ids=['int4_kv'])
def test_unported_decoding_options_raise(options):
    """Packed int4 cross K/V, the last option that was not ported, now
    decodes; a cross K/V width with no grid still raises."""
    from stable_ts_tpu_torch.loaders import load_test_model
    model = load_test_model(seed=0, device='cpu')
    mel = torch.zeros((80, 3000))
    (result,) = model.decode(mel, language='en', sample_len=4, **options)
    assert len(result.tokens) <= 4
    with pytest.raises(ValueError, match='bits'):
        model.decode(mel, language='en', sample_len=4, kv_quant=9)


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
    model = WhisperTorch(dims, init_params(dims, device='cpu'), device='cpu', ranks=ranks)
    mel = torch.zeros((80, 3000))
    (code,), probs = model.detect_language(mel)
    assert code in probs[0] and probs[0][code] == max(probs[0].values())
    (result,) = model.decode(mel, sample_len=4)
    assert result.language == code


def test_transcribe_minimal_matches_jax(monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=HEADS)
    port_model = from_jax(jax_model, device='cpu')
    audio = _gapped_audio()
    kw = dict(language='en', temperature=0, verbose=None)
    ref = jax_model.transcribe_minimal(audio, **kw)
    got = port_model.transcribe_minimal(audio, **kw)
    assert got.text == ref.text and len(ref.segments) > 0
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    with pytest.raises(TypeError, match='beam_size'):
        port_model.transcribe_minimal(audio, beam_size=2)


def _traces(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith('.pt.trace.json'))


def test_profile_env_traces_a_request(tmp_path, monkeypatch):
    """With STABLE_TS_TPU_PROFILE set, transcribe writes one Chrome trace
    under <dir>/transcribe that names the request's ops; unset, none."""
    import json
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu', alignment_heads=HEADS)
    audio = _audio(4)
    monkeypatch.delenv('STABLE_TS_TPU_PROFILE', raising=False)
    model.transcribe(audio, language='en', temperature=0, verbose=None)
    assert _traces(tmp_path) == []
    monkeypatch.setenv('STABLE_TS_TPU_PROFILE', str(tmp_path))
    model.transcribe(audio, language='en', temperature=0, verbose=None)
    (trace,) = _traces(tmp_path)
    assert trace.startswith('transcribe' + os.sep)
    with open(tmp_path / trace) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    assert any(n.startswith('aten::') for n in names)


def test_nested_tasks_reuse_the_outer_trace(tmp_path):
    """A task entered inside a traced one records into the outer trace:
    one file, under the outer task's directory; profile_trace alone writes
    one file too."""
    from stable_ts_tpu_torch import load_test_model
    from stable_ts_tpu_torch.profiling import maybe_trace, profile_trace
    model = load_test_model(device='cpu', alignment_heads=HEADS)
    env = tmp_path / 'env'
    with maybe_trace('outer', log_dir=str(env)):
        with maybe_trace('inner', log_dir=str(env)):
            model.transcribe(_audio(4), language='en', temperature=0, verbose=None)
    (trace,) = _traces(env)
    assert trace.startswith('outer' + os.sep)
    with profile_trace(str(tmp_path / 'direct')) as prof:
        torch.ones(3).sum()
    assert prof is not None and len(_traces(tmp_path / 'direct')) == 1
