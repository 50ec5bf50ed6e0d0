"""The port's command line, ``stable-ts-tpu-torch`` (stable_ts_tpu_torch/cli.py).

First stable_ts_tpu's own CLI cases (tests/test_cli.py), on the port's
CLI with the fakes patched on the port's loaders: the reference flag
surface parses, outputs map to inputs, JSON input is reprocessed without a
model, unfinished results are saved and resumed, the model is cached
across requests and the escape hatches reach the model. Then what is the
port's own: ``--device`` takes cuda (the default) or cpu and nothing else,
``--dtype`` / ``--fp16`` give torch dtypes, ``--shard --tp`` shards the
loaded model and only rank 0 writes, ``-fw`` / ``-mlx`` raise as
stable_ts_tpu's do, ``--persist`` serves requests from stdin on one loaded
model, and ``python -m stable_ts_tpu_torch`` runs the same ``cli()``. The copy of
video_output.py refuses to run without ffmpeg, as stable_ts_tpu's does.

Last, one parametrised parity test runs stable_ts_tpu's ``cli()`` and the
port's (``--device cpu --dtype float32``) on the same tiny ``.pt`` (JAX's
``save_openai_checkpoint`` of ``init_params(tiny_test_dims(), seed=3)``, as
tests/test_torch_checkpoints.py writes it) and the same 20-s WAV of
seeded noise. JAX runs as the port's other parity tests run it on the
CPU (STABLE_TS_TPU_CROSS=interpret, STABLE_TS_TPU_SELFKV=1,
STABLE_TS_TPU_EPI=0). Every case decodes at temperature 0 alone
(``--temperature_increment_on_fallback None``): the fallback ladder's
samples come from a torch.Generator in the port and from a PRNGKey in JAX,
other draws by design. SRT, VTT, ASS, TSV and TXT bytes must be equal;
the JSON results equal in text, tokens and words, with every segment and
word time within 0.021 s (tests/test_torch_slice.py's one 20-ms frame plus
rounding) and probabilities within 1e-6. The dyn case (``-dq`` with
STABLE_TS_TPU_WOQ=dyn in both) holds the same tokens, text and words, TXT
bytes and probabilities within 1e-5, but not the times: an activation one
bit off moves its int8 code, which moves the dynamic head selection of
this checkpoint without known heads, and JAX's own dyn output moves with
the last bit of its input (tests/test_torch_quant.py,
``test_dyn_moves_with_the_last_bit_of_the_input``).
"""
import os

import pytest

from stable_ts_tpu_torch.cli import build_parser


@pytest.fixture(scope='module')
def parser():
    return build_parser()


class TestReferenceFlagSurface:
    """Every reference CLI flag parses (reference cli.py:124-391)."""

    REFERENCE_FLAGS = [
        ['--model', 'base'], ['--model_dir', '/tmp'], ['--output', 'o.srt'],
        ['--output_dir', '/tmp'], ['--output_format', 'srt'],
        ['--verbose', '2'], ['--task', 'translate'], ['--language', 'en'],
        ['--temperature', '0.2'], ['--best_of', '5'], ['--beam_size', '5'],
        ['--patience', '1.0'], ['--length_penalty', '0.5'],
        ['--suppress_tokens', '-1'], ['--initial_prompt', 'hi'],
        ['--condition_on_previous_text', 'true'],
        ['--temperature_increment_on_fallback', '0.2'],
        ['--compression_ratio_threshold', '2.4'],
        ['--logprob_threshold', '-1.0'], ['--no_speech_threshold', '0.6'],
        ['--word_timestamps', 'true'], ['--regroup', 'cm_sg=.5'],
        ['--suppress_silence', 'true'], ['--suppress_word_ts', 'true'],
        ['--suppress_ts_tokens', 'false'], ['--vad', 'true'],
        ['--vad_threshold', '0.35'], ['--q_levels', '20'], ['--k_size', '5'],
        ['--min_word_dur', '0.1'], ['--nonspeech_error', '0.1'],
        ['--gap_padding', ' ...'], ['--prepend_punctuations', '"'],
        ['--append_punctuations', '.'], ['--denoiser', 'spectral_gate'],
        ['--only_voice_freq'], ['--segment_level', 'true'],
        ['--word_level', 'true'], ['--min_dur', '0.02'],
        ['--tag', '<b>', '</b>'], ['--font', 'Arial'], ['--font_size', '48'],
        ['--karaoke', 'true'], ['--strip', 'true'],
        # compat group
        ['--device', 'cpu'], ['--fp16', 'true'], ['--cpu_preload', 'true'],
        ['--threads', '4'], ['--demucs', 'true'],
        ['--demucs_option', 'shifts=1'], ['--denoiser_option', 'a=1'],
        ['--denoiser_output', '/tmp/x.wav'], ['--only_ffmpeg'],
        ['--mel_first'], ['--no_stream'], ['--reverse_text', 'true'],
        ['--vad_onnx', 'false'], ['--time_scale', '1.0'], ['--ts_num', '1'],
        ['--ts_noise', '0.1'], ['--faster_whisper'],
        ['--huggingface_whisper'], ['--mlx_whisper'],
        ['--save_unfinished'], ['--resume_input', 'x.json'],
        ['--delete_resume'], ['--dynamic_quantization'],
        ['--persist'], ['--overwrite'], ['--debug'],
    ]

    @pytest.mark.parametrize('flag', REFERENCE_FLAGS,
                             ids=[f[0] for f in REFERENCE_FLAGS])
    def test_flag_parses(self, parser, flag):
        parser.parse_args(['in.wav'] + flag)

    def test_resume_aliases(self, parser):
        a = parser.parse_args(['in.wav', '--resume_input', 'r.json'])
        b = parser.parse_args(['in.wav', '--resume', 'r.json'])
        assert a.resume == b.resume == 'r.json'

    def test_short_flags(self, parser):
        a = parser.parse_args(['in.wav', '-dq', '-su', '-dr', '-y', '-p',
                               '-ovf', '-fw'])
        assert a.dynamic_quantization and a.save_unfinished
        assert a.delete_resume and a.overwrite and a.persist
        assert a.only_voice_freq and a.faster_whisper


class TestCompatBehavior:
    @pytest.mark.parametrize('flag', ['-fw', '-mlx'])
    def test_unsupported_backends_raise(self, parser, tmp_path, flag):
        """As stable_ts_tpu's CLI, whatever is installed."""
        from stable_ts_tpu_torch.cli import _run_once
        args = parser.parse_args([str(tmp_path / 'x.wav'), flag])
        with pytest.raises(NotImplementedError, match='transcribe_any'):
            _run_once(args, {})

    @pytest.mark.parametrize('device', ['tpu', 'gpu', 'mps'])
    def test_unknown_device_raises(self, parser, tmp_path, device, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        args = parser.parse_args([_wav(tmp_path / 'a.wav'), '--device', device,
                                  '-y', '-v', '0', '-d', str(tmp_path)])
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            _run_once(args, {})
        assert fake_model.calls == []

    def test_device_and_dtype_reach_load_model(self, parser, tmp_path,
                                               monkeypatch):
        """No --device means cuda, as for every entry point of the port;
        --dtype and --fp16 give torch dtypes, none gives None (f32)."""
        import torch
        from stable_ts_tpu_torch import loaders as loaders_mod
        from stable_ts_tpu_torch.cli import _run_once
        loads = []

        def load(**kw):
            loads.append(kw)
            return _FakeModel()
        monkeypatch.setattr(loaders_mod, 'load_model', load)
        wav = _wav(tmp_path / 'a.wav')
        base = [wav, '-y', '-v', '0', '-d', str(tmp_path)]
        for extra in ([], ['--device', 'CPU', '--dtype', 'bfloat16'],
                      ['--fp16', 'true'], ['--fp16', 'false', '--device', 'cuda']):
            _run_once(parser.parse_args(base + extra), {})
        assert [(kw['device'], kw['dtype']) for kw in loads] == [
            ('cuda', None), ('cpu', torch.bfloat16), ('cuda', torch.bfloat16),
            ('cuda', torch.float32)]

    def test_cuda_without_a_gpu_raises(self, tmp_path):
        """The default device with no GPU: the loader's error, no fallback
        to the CPU."""
        import torch
        if torch.cuda.is_available():
            pytest.skip('a GPU is present: cuda is legitimate here')
        from stable_ts_tpu_torch.cli import cli
        with pytest.raises(RuntimeError, match='CUDA'):
            cli([_wav(tmp_path / 'a.wav'), '--model', 'missing.pt', '-y',
                 '-v', '0', '-d', str(tmp_path)])

    def test_shard_raises_naming_the_roadmap_item(self, parser, tmp_path,
                                                  fake_model, monkeypatch):
        """``--shard --tp 2`` no longer raises: the loaded model is sharded
        with tp=2 and transcribes, and a rank other than 0 writes no
        output file."""
        import torch.distributed as dist
        from stable_ts_tpu_torch.cli import _run_once
        wav = _wav(tmp_path / 'a.wav')
        out_dir = tmp_path / 'out'
        args = parser.parse_args([wav, '--shard', '--tp', '2', '-y', '-v', '0',
                                  '-d', str(out_dir)])
        monkeypatch.setattr(dist, 'is_initialized', lambda: True)
        monkeypatch.setattr(dist, 'get_rank', lambda: 1)
        _run_once(args, {})
        assert [c[0] for c in fake_model.calls] == ['shard', 'transcribe']
        assert fake_model.calls[0][1] == {'tp': 2}
        assert not out_dir.exists()
        monkeypatch.setattr(dist, 'get_rank', lambda: 0)
        _run_once(args, {})
        assert (out_dir / 'a.srt').exists()

    def test_tp_without_shard_warns(self, parser, tmp_path, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        args = parser.parse_args([_wav(tmp_path / 'a.wav'), '--tp', '2',
                                  '-y', '-v', '0', '-d', str(tmp_path)])
        with pytest.warns(UserWarning, match='--tp has no effect'):
            _run_once(args, {})
        assert [c[0] for c in fake_model.calls] == ['transcribe']

    def test_deprecated_flags_warn(self, parser, tmp_path, monkeypatch):
        from stable_ts_tpu_torch import cli as cli_mod
        from stable_ts_tpu_torch import loaders as loaders_mod
        args = parser.parse_args([str(tmp_path / 'x.wav'),
                                  '--time_scale', '2.0'])

        # stop before any model loading (cli imports load_model from
        # .loaders inside _run_once, so patch it at its source)
        def boom(**kw):
            raise RuntimeError('stop-before-load')
        monkeypatch.setattr(loaders_mod, 'load_model', boom)
        with pytest.warns(UserWarning, match='time_scale'):
            with pytest.raises(RuntimeError, match='stop-before-load'):
                cli_mod._run_once(args, {})


def _word(word, start, end, prob=0.9):
    return dict(word=word, start=start, end=end, probability=prob)


def _mini_result(words=None, unfinished=-1.0):
    from stable_ts_tpu_torch.result import WhisperResult
    words = words or [_word(' hello', 0.0, 0.4), _word(' world', 0.5, 0.9)]
    res = WhisperResult([words])
    res.unfinished_start = unfinished
    return res


class _FakeModel:
    """Stands in for WhisperTorch: records calls, returns canned results."""

    def __init__(self, result_factory=None):
        self.calls = []
        self._factory = result_factory or (lambda **kw: _mini_result())

    def transcribe(self, **kwargs):
        self.calls.append(('transcribe', kwargs))
        return self._factory(**kwargs)

    transcribe_minimal = transcribe_batched = transcribe

    def shard(self, **kwargs):
        self.calls.append(('shard', kwargs))
        return self

    def refine(self, **kwargs):
        self.calls.append(('refine', kwargs))
        return kwargs['result']


@pytest.fixture
def fake_model(monkeypatch):
    from stable_ts_tpu_torch import loaders as loaders_mod
    model = _FakeModel()
    monkeypatch.setattr(loaders_mod, 'load_model',
                        lambda **kw: model)
    return model


def _wav(path, seconds=1.0, audio=None):
    import wave
    import numpy as np
    if audio is None:
        audio = np.zeros(int(16000 * seconds))
    pcm = (np.clip(audio, -1, 1) * 32767).astype('<i2')
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


class TestOutputMapping:
    """Multi-input -> multi-output path mapping (reference cli.py:582)."""

    def test_default_stem_mapping(self, tmp_path):
        from stable_ts_tpu_torch.cli import _finalize_outputs
        ins = [str(tmp_path / 'a.wav'), str(tmp_path / 'sub' / 'b.flac')]
        outs = _finalize_outputs(ins, None, None, None)
        assert outs == [[str(tmp_path / 'a.srt')],
                        [str(tmp_path / 'sub' / 'b.srt')]]

    def test_output_dir_redirects(self, tmp_path):
        from stable_ts_tpu_torch.cli import _finalize_outputs
        outs = _finalize_outputs(['/x/a.wav'], None, str(tmp_path),
                                 ['srt', 'json'])
        assert outs == [[str(tmp_path / 'a.srt'), str(tmp_path / 'a.json')]]

    def test_explicit_outputs_one_per_input(self):
        from stable_ts_tpu_torch.cli import _finalize_outputs
        outs = _finalize_outputs(['a.wav', 'b.wav'], ['x.srt', 'y.vtt'],
                                 None, None)
        assert outs == [['x.srt'], ['y.vtt']]

    def test_explicit_outputs_with_formats_fan_out(self):
        from stable_ts_tpu_torch.cli import _finalize_outputs
        outs = _finalize_outputs(['a.wav'], ['out.srt'], None, ['srt', 'ass'])
        assert outs == [['out.srt', 'out.ass']]

    def test_count_mismatch_raises(self):
        from stable_ts_tpu_torch.cli import _finalize_outputs
        with pytest.raises(ValueError, match='2 input'):
            _finalize_outputs(['a.wav', 'b.wav'], ['only.srt'], None, None)

    def test_bad_output_format_rejected(self, parser, tmp_path, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        args = parser.parse_args([_wav(tmp_path / 'a.wav'), '-f', 'mkv'])
        with pytest.raises(NotImplementedError, match='mkv'):
            _run_once(args, {})


class TestJsonReprocessing:
    """A .json input is reprocessed without transcription or model load
    (reference cli.py:702-703)."""

    def _saved_json(self, tmp_path):
        path = str(tmp_path / 'res.json')
        _mini_result().save_as_json(path)
        return path

    def test_json_to_srt_without_model(self, tmp_path, parser, monkeypatch):
        from stable_ts_tpu_torch import loaders as loaders_mod
        from stable_ts_tpu_torch.cli import _run_once

        def no_load(**kw):
            raise AssertionError('model must not load for JSON input')
        monkeypatch.setattr(loaders_mod, 'load_model', no_load)
        src = self._saved_json(tmp_path)
        out = str(tmp_path / 'res.srt')
        args = parser.parse_args([src, '-o', out, '-y', '-v', '0'])
        _run_once(args, {})
        text = open(out).read()
        assert 'hello' in text and '-->' in text

    def test_json_multi_format(self, tmp_path, parser):
        src = self._saved_json(tmp_path)
        args = parser.parse_args([src, '-f', 'srt,vtt,txt', '-y', '-v', '0',
                                  '-d', str(tmp_path / 'out')])
        from stable_ts_tpu_torch.cli import _run_once
        _run_once(args, {})
        for ext in ('srt', 'vtt', 'txt'):
            assert (tmp_path / 'out' / f'res.{ext}').exists()

    def test_json_with_regroup_string(self, tmp_path, parser):
        src = self._saved_json(tmp_path)
        out = str(tmp_path / 'r.json')
        args = parser.parse_args([src, '-o', out, '-y', '-v', '0'])
        from stable_ts_tpu_torch.cli import _run_once
        _run_once(args, {})
        import json as json_mod
        saved = json_mod.load(open(out))
        assert saved['segments']


class TestResumeFlow:
    """-UNFINISHED saving and --resume_input wiring (reference cli.py:771)."""

    def test_unfinished_result_saved(self, tmp_path, parser, monkeypatch):
        from stable_ts_tpu_torch import loaders as loaders_mod
        from stable_ts_tpu_torch.cli import _run_once
        model = _FakeModel(lambda **kw: _mini_result(unfinished=30.0))
        monkeypatch.setattr(loaders_mod, 'load_model', lambda **kw: model)
        wav = _wav(tmp_path / 'long.wav')
        args = parser.parse_args([wav, '-su', '-y', '-v', '0',
                                  '-d', str(tmp_path)])
        _run_once(args, {})
        unfinished = tmp_path / 'long-UNFINISHED.json'
        assert unfinished.exists()
        # the ordinary output must NOT be written for an unfinished result
        assert not (tmp_path / 'long.srt').exists()

    def test_resume_passed_to_transcribe_and_deleted(self, tmp_path, parser,
                                                     fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        resume_path = str(tmp_path / 'long-UNFINISHED.json')
        _mini_result(unfinished=30.0).save_as_json(resume_path)
        wav = _wav(tmp_path / 'long.wav')
        args = parser.parse_args([wav, '--resume_input', resume_path, '-dr',
                                  '-y', '-v', '0', '-d', str(tmp_path)])
        _run_once(args, {})
        kwargs = fake_model.calls[0][1]
        assert kwargs['resume'] == resume_path
        assert not os.path.exists(resume_path)  # --delete_resume
        assert (tmp_path / 'long.srt').exists()

    def test_resume_kept_without_delete_flag(self, tmp_path, parser, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        resume_path = str(tmp_path / 'r-UNFINISHED.json')
        _mini_result(unfinished=30.0).save_as_json(resume_path)
        wav = _wav(tmp_path / 'r.wav')
        args = parser.parse_args([wav, '--resume', resume_path,
                                  '-y', '-v', '0', '-d', str(tmp_path)])
        _run_once(args, {})
        assert os.path.exists(resume_path)


class TestModelCacheAndOptions:
    def test_model_cached_across_runs(self, tmp_path, parser, monkeypatch):
        from stable_ts_tpu_torch import loaders as loaders_mod
        from stable_ts_tpu_torch.cli import _run_once
        loads = []

        def load(**kw):
            loads.append(kw)
            return _FakeModel()
        monkeypatch.setattr(loaders_mod, 'load_model', load)
        wav = _wav(tmp_path / 'a.wav')
        cache = {}
        args = parser.parse_args([wav, '-y', '-v', '0', '-d', str(tmp_path)])
        _run_once(args, cache)
        _run_once(args, cache)  # persist-REPL reuse
        assert len(loads) == 1
        args2 = parser.parse_args([wav, '-y', '-v', '0', '-d', str(tmp_path),
                                   '--model', 'other'])
        _run_once(args2, cache)
        assert len(loads) == 2  # model change reloads

    def test_transcribe_option_escape_hatch(self, tmp_path, parser, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        wav = _wav(tmp_path / 'a.wav')
        args = parser.parse_args([wav, '-y', '-v', '0', '-d', str(tmp_path),
                                  '--transcribe_option', 'nonspeech_skip=5.0'])
        _run_once(args, {})
        assert fake_model.calls[0][1]['nonspeech_skip'] == 5.0

    def test_multiple_inputs_each_transcribed(self, tmp_path, parser, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        wavs = [_wav(tmp_path / 'a.wav'), _wav(tmp_path / 'b.wav')]
        args = parser.parse_args(wavs + ['-y', '-v', '0', '-d', str(tmp_path)])
        _run_once(args, {})
        assert [c[0] for c in fake_model.calls] == ['transcribe', 'transcribe']
        assert (tmp_path / 'a.srt').exists() and (tmp_path / 'b.srt').exists()

    def test_refine_applied_after_transcribe(self, tmp_path, parser, fake_model):
        from stable_ts_tpu_torch.cli import _run_once
        wav = _wav(tmp_path / 'a.wav')
        args = parser.parse_args([wav, '-r', '-y', '-v', '0',
                                  '-d', str(tmp_path)])
        _run_once(args, {})
        assert [c[0] for c in fake_model.calls] == ['transcribe', 'refine']


def test_batched_method_forwards_stabilization_options(tmp_path, fake_model):
    """--transcribe_method transcribe_batched must forward the shared
    stabilization/decode options and --batch_size."""
    from stable_ts_tpu_torch.cli import cli
    wav = _wav(tmp_path / 'a.wav')
    cli([wav, '-y', '-v', '0', '-d', str(tmp_path),
         '--transcribe_method', 'transcribe_batched',
         '--batch_size', '4', '--max_instant_words', '0.7',
         '--suppress_ts_tokens', 'True',
         '--nonspeech_skip', '4.5', '--beam_size', '2'])
    kwargs = fake_model.calls[0][1]
    assert kwargs['batch_size'] == 4
    assert kwargs['max_instant_words'] == 0.7
    assert kwargs['suppress_ts_tokens'] is True
    assert kwargs['nonspeech_skip'] == 4.5
    assert kwargs['beam_size'] == 2
    # resume is supported by the batched driver too
    assert 'resume' in kwargs and kwargs['resume'] is None


# -- the port's own surface ------------------------------------------------------------------

def test_persist_serves_stdin_requests_on_one_model(tmp_path, monkeypatch, capsys):
    """--persist: the argv request, then two read from stdin; one load."""
    import io
    from stable_ts_tpu_torch import loaders as loaders_mod
    from stable_ts_tpu_torch.cli import cli
    loads = []
    model = _FakeModel()

    def load(**kw):
        loads.append(kw)
        return model
    monkeypatch.setattr(loaders_mod, 'load_model', load)
    wavs = [_wav(tmp_path / f'{name}.wav') for name in 'abc']
    out = str(tmp_path / 'out')
    lines = [f'{wav} -y -v 0 -d {out} -f txt' for wav in wavs[1:]]
    monkeypatch.setattr('sys.stdin', io.StringIO('\n'.join(lines) + '\nexit\n'))
    cli([wavs[0], '-p', '-y', '-v', '0', '-d', out, '-f', 'txt'])
    assert len(loads) == 1
    assert [c[0] for c in model.calls] == ['transcribe'] * 3
    for name in 'abc':
        assert (tmp_path / 'out' / f'{name}.txt').exists()
    assert capsys.readouterr().out.count('stable-ts-tpu-torch> ') == 3


def test_module_entry_prints_the_version():
    import subprocess
    import sys
    from stable_ts_tpu_torch import __version__
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-m', 'stable_ts_tpu_torch', '--version'],
                          capture_output=True, text=True, cwd=repo, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == f'stable-ts-tpu-torch {__version__}'


def test_console_script_is_declared():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'setup.py')) as f:
        setup_py = f.read()
    assert "'stable-ts-tpu-torch=stable_ts_tpu_torch.cli:cli'" in setup_py
    assert "'stable-ts-tpu=stable_ts_tpu.cli:cli'" in setup_py


class TestVideoComparisonGating:
    """tests/test_visualization.py's case, on the port's copy of
    video_output.py (exported as stable_ts_tpu_torch.encode_video_comparison)."""

    def test_missing_ffmpeg_raises_helpfully(self, tmp_path):
        import shutil
        if shutil.which('ffmpeg'):
            pytest.skip('ffmpeg present; gating untestable')
        from stable_ts_tpu_torch.video_output import encode_video_comparison
        with pytest.raises((FileNotFoundError, RuntimeError, OSError)):
            encode_video_comparison('a.mp4', ['x.srt', 'y.srt'],
                                    output_videopath=str(tmp_path / 'o.mp4'))


# -- parity with stable_ts_tpu's CLI ---------------------------------------------------------

FORMATS = ('srt', 'vtt', 'ass', 'tsv', 'txt')
TIME_TOL = 0.021
PROB_TOL = 1e-6


@pytest.fixture(scope='module')
def cli_inputs(tmp_path_factory):
    """The tiny .pt, a 20-s WAV of seeded noise and a JSON result JAX wrote
    for it (the input of --align_words and of JSON reprocessing)."""
    import numpy as np
    from stable_ts_tpu.loaders import load_model
    from stable_ts_tpu.models.whisper.load import save_openai_checkpoint
    from stable_ts_tpu.models.whisper.model import init_params, tiny_test_dims
    root = tmp_path_factory.mktemp('cli_parity')
    pt = str(root / 'tiny.pt')
    save_openai_checkpoint(pt, tiny_test_dims(), init_params(tiny_test_dims(), seed=3))
    audio = (np.random.default_rng(21).standard_normal(16000 * 20) * 0.1).astype(np.float32)
    wav = _wav(root / 'noise.wav', audio=audio)
    mp = pytest.MonkeyPatch()
    for name, value in _JAX_KNOBS.items():
        mp.setenv(name, value)
    try:
        result = load_model(pt).transcribe(wav, language='en', temperature=0,
                                           verbose=None)
    finally:
        mp.undo()
    js = str(root / 'prior.json')
    result.save_as_json(js)
    assert result.has_words and len(result.segments) > 1
    return dict(pt=pt, wav=wav, json=js)


_JAX_KNOBS = dict(STABLE_TS_TPU_CROSS='interpret', STABLE_TS_TPU_SELFKV='1',
                  STABLE_TS_TPU_EPI='0')

PARITY_CASES = [
    ('default', [], None),
    ('transcribe_batched', ['--transcribe_method', 'transcribe_batched',
                            '--batch_size', '2'], None),
    ('transcribe_minimal', ['--transcribe_method', 'transcribe_minimal'], None),
    ('beam_size_2', ['--beam_size', '2'], None),
    ('align_text', ['--align', 'text: the quick brown fox jumps over the lazy dog'], None),
    ('align_words', ['--align_words', '{json}'], None),
    ('refine', ['--refine', '--refine_option', 'prob_threshold=0.0'], None),
    ('locate', ['--locate', '{word}', '--locate_option', 'probability_threshold=0.0',
                'mode=0'], None),
    ('dq_astype', ['-dq'], None),
    ('dq_dyn', ['-dq'], 'dyn'),
    ('max_chars', ['--max_chars', '6'], None),
    ('regroup_false', ['--regroup', 'False'], None),
    ('karaoke', ['--karaoke', 'True'], None),
    ('json_to_srt', [], None),
]


def _first_word(path):
    """The first word of the prior result, the target of --locate."""
    import json
    with open(path) as f:
        return json.load(f)['segments'][0]['words'][0]['word'].strip()


def _run_cli(cli, argv, capsys):
    capsys.readouterr()
    cli(argv)
    return capsys.readouterr().out


def _json_matches(got_path, ref_path, times=True, prob_tol=PROB_TOL):
    import json
    with open(got_path) as f:
        got = json.load(f)
    with open(ref_path) as f:
        ref = json.load(f)
    assert len(got['segments']) == len(ref['segments']) > 0
    for sg, sr in zip(got['segments'], ref['segments']):
        assert sg['text'] == sr['text'] and sg['tokens'] == sr['tokens']
        assert len(sg['words']) == len(sr['words'])
        pairs = [(sg, sr)] + list(zip(sg['words'], sr['words']))
        for wg, wr in pairs[1:]:
            assert wg['word'] == wr['word'] and wg['tokens'] == wr['tokens']
            assert wg['probability'] == pytest.approx(wr['probability'], abs=prob_tol)
        for a, b in pairs if times else ():
            assert abs(a['start'] - b['start']) <= TIME_TOL
            assert abs(a['end'] - b['end']) <= TIME_TOL


@pytest.mark.parametrize('case,extra,woq', PARITY_CASES,
                         ids=[c[0] for c in PARITY_CASES])
def test_cli_matches_jax(case, extra, woq, cli_inputs, tmp_path, monkeypatch, capsys):
    import jax
    from stable_ts_tpu.cli import cli as jax_cli
    from stable_ts_tpu_torch.cli import cli as port_cli
    for name, value in _JAX_KNOBS.items():
        monkeypatch.setenv(name, value)
    if woq:
        # read when JAX traces: the traces under the default stay out of
        # this case, and this case's out of the next
        monkeypatch.setenv('STABLE_TS_TPU_WOQ', woq)
        jax.clear_caches()
    extra = [a.format(json=cli_inputs['json'], word=' ' + _first_word(cli_inputs['json']))
             for a in extra]
    source = cli_inputs['json'] if case == 'json_to_srt' else cli_inputs['wav']
    common = [source, '--model', cli_inputs['pt'], '--language', 'en',
              '--temperature_increment_on_fallback', 'None', '-y', '-v', '0',
              '--dtype', 'float32', '-f', ','.join(FORMATS + ('json',))] + extra
    try:
        ref_out = _run_cli(jax_cli, common + ['-d', str(tmp_path / 'jax')], capsys)
    finally:
        if woq:
            jax.clear_caches()
    got_out = _run_cli(port_cli, common + ['-d', str(tmp_path / 'port'),
                                           '--device', 'cpu'], capsys)
    stem = os.path.splitext(os.path.basename(source))[0]
    if case == 'locate':
        assert got_out == ref_out and ref_out.strip()
        assert not os.path.exists(tmp_path / 'port')
        return
    if woq == 'dyn':
        assert ((tmp_path / 'port' / f'{stem}.txt').read_bytes()
                == (tmp_path / 'jax' / f'{stem}.txt').read_bytes())
        _json_matches(tmp_path / 'port' / f'{stem}.json',
                      tmp_path / 'jax' / f'{stem}.json', times=False, prob_tol=1e-5)
        return
    for fmt in FORMATS:
        ref = (tmp_path / 'jax' / f'{stem}.{fmt}').read_bytes()
        got = (tmp_path / 'port' / f'{stem}.{fmt}').read_bytes()
        assert got == ref, fmt
    if case == 'json_to_srt':
        assert (tmp_path / 'port' / f'{stem}.json').read_bytes() == \
            (tmp_path / 'jax' / f'{stem}.json').read_bytes()
    _json_matches(tmp_path / 'port' / f'{stem}.json', tmp_path / 'jax' / f'{stem}.json')


def test_cli_shard_under_torchrun_matches_jax_shard(cli_inputs, tmp_path,
                                                   monkeypatch, capsys):
    """``torchrun --nproc_per_node 2 -m stable_ts_tpu_torch ... --shard --tp
    2 --device cpu``: two gloo ranks, the tiny model's two heads split
    over them, write stable_ts_tpu's ``--shard --tp 2`` output files (its
    8-device CPU mesh, dp 4 x tp 2) byte for byte, the JSON within the
    parity tolerances. JAX's mesh turns its fused kernels off
    process-wide; they are turned back on, and the traces dropped,
    afterwards."""
    import socket
    import subprocess
    import sys
    import jax
    from stable_ts_tpu.cli import cli as jax_cli
    from stable_ts_tpu.models.whisper import model as model_mod
    for name, value in _JAX_KNOBS.items():
        monkeypatch.setenv(name, value)
    common = [cli_inputs['wav'], '--model', cli_inputs['pt'], '--language', 'en',
              '--temperature_increment_on_fallback', 'None', '-y', '-v', '0',
              '--dtype', 'float32', '-f', ','.join(FORMATS + ('json',)),
              '--shard', '--tp', '2']
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env['CUDA_VISIBLE_DEVICES'] = ''
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
         '--nproc_per_node', '2', '--master_addr', '127.0.0.1',
         '--master_port', str(port), '-m', 'stable_ts_tpu_torch', *common,
         '-d', str(tmp_path / 'port'), '--device', 'cpu'],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    was_on = model_mod.fused_kernels_enabled()
    try:
        _run_cli(jax_cli, common + ['-d', str(tmp_path / 'jax')], capsys)
    finally:
        model_mod.set_fused_kernels_enabled(was_on)
        jax.clear_caches()
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-4000:]
    for fmt in FORMATS:
        assert ((tmp_path / 'port' / f'noise.{fmt}').read_bytes()
                == (tmp_path / 'jax' / f'noise.{fmt}').read_bytes()), fmt
    _json_matches(tmp_path / 'port' / 'noise.json', tmp_path / 'jax' / 'noise.json')
