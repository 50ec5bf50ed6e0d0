"""Checkpoint loading in the port against stable_ts_tpu on the CPU.

The checkpoints are written here, as the JAX package's own tests write
them: an OpenAI ``.pt`` by JAX's ``save_openai_checkpoint`` from
``init_params(tiny_test_dims(), seed=3)``, an HF directory (config.json and
safetensors, one file or two shards) and an MLX directory (OpenAI names,
conv weights (out, width, in)) re-encoded from that state dict. The port's
loaders must give, tensor for tensor and bit for bit, the model that
``from_jax_params`` makes of JAX's loader's params for the same files; the
port's writer must give a file JAX's reader loads to the same weights. The
port's own safetensors reader must equal the ``safetensors`` package's.
``load_model`` resolves names, finds the vocabulary beside the checkpoint,
and a transcribe from a loaded checkpoint gives JAX's text and SRT bytes.
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _openai_to_hf_key(key: str) -> str:
    # as tests/test_whisper_model.py writes HF names; the *_ln fragments
    # contain the attn fragments, so order matters
    pairs = [
        ('mlp_ln', 'final_layer_norm'),
        ('cross_attn_ln', 'encoder_attn_layer_norm'),
        ('attn_ln', 'self_attn_layer_norm'),
        ('cross_attn', 'encoder_attn'),
        ('attn', 'self_attn'),
        ('mlp.0', 'fc1'), ('mlp.2', 'fc2'),
        ('query', 'q_proj'), ('key', 'k_proj'), ('value', 'v_proj'),
        ('out', 'out_proj'),
        ('blocks', 'layers'),
        ('positional_embedding', 'embed_positions.weight'),
        ('token_embedding', 'embed_tokens'),
        ('encoder.ln_post', 'encoder.layer_norm'),
        ('decoder.ln', 'decoder.layer_norm'),
    ]
    for old, new in pairs:
        key = key.replace(old, new)
    return 'model.' + key


def _jax_dims_params(seed=3, **dims_kw):
    import dataclasses
    from stable_ts_tpu.models.whisper.model import init_params, tiny_test_dims
    dims = dataclasses.replace(tiny_test_dims(), **dims_kw)
    return dims, init_params(dims, seed=seed)


def _port_dims(jax_dims):
    from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions
    return ModelDimensions(**vars(jax_dims))


def _write_pt(tmp_path, name='tiny.pt', seed=3, **dims_kw):
    from stable_ts_tpu.models.whisper.load import save_openai_checkpoint
    dims, params = _jax_dims_params(seed, **dims_kw)
    path = str(tmp_path / name)
    save_openai_checkpoint(path, dims, params)
    return path, dims


def _state_dict(pt_path):
    return torch.load(pt_path, map_location='cpu', weights_only=False)['model_state_dict']


def _write_hf_dir(tmp_path, pt_path, dims, shards=1):
    from safetensors.numpy import save_file
    hf_sd = {_openai_to_hf_key(k): v.numpy() for k, v in _state_dict(pt_path).items()}
    hf_sd['proj_out.weight'] = hf_sd['model.decoder.embed_tokens.weight']
    hdir = tmp_path / 'hf'
    os.makedirs(hdir)
    names = sorted(hf_sd)
    for i in range(shards):
        part = {k: hf_sd[k] for k in names[i::shards]}
        save_file(part, str(hdir / f'model-{i + 1:05d}-of-{shards:05d}.safetensors'))
    with open(hdir / 'config.json', 'w') as f:
        json.dump(dict(
            num_mel_bins=dims.n_mels, max_source_positions=dims.n_audio_ctx,
            d_model=dims.n_audio_state, encoder_attention_heads=dims.n_audio_head,
            encoder_layers=dims.n_audio_layer, vocab_size=dims.n_vocab,
            max_target_positions=dims.n_text_ctx,
            decoder_attention_heads=dims.n_text_head,
            decoder_layers=dims.n_text_layer), f)
    return str(hdir)


def _write_mlx_dir(tmp_path, pt_path, dims, config_extra=None):
    from safetensors.numpy import save_file
    out = {}
    for k, v in _state_dict(pt_path).items():
        arr = v.numpy()
        if 'conv' in k and arr.ndim == 3:
            arr = arr.transpose(0, 2, 1)   # torch (out, in, k) -> mlx (out, k, in)
        out[k] = np.ascontiguousarray(arr)
    mdir = tmp_path / 'mlx-model'
    os.makedirs(mdir)
    save_file(out, str(mdir / 'weights.safetensors'))
    with open(mdir / 'config.json', 'w') as f:
        json.dump({**dims.__dict__, 'model_type': 'whisper', **(config_extra or {})}, f)
    return str(mdir)


def _assert_same_weights(got, ref):
    got_p = dict(got.named_parameters())
    ref_p = dict(ref.named_parameters())
    assert sorted(got_p) == sorted(ref_p)
    for name, p in ref_p.items():
        assert got_p[name].dtype == p.dtype, name
        assert torch.equal(got_p[name], p), name


def _from_jax(params, jax_dims):
    from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
    return from_jax_params(params, _port_dims(jax_dims), device='cpu')


def test_openai_pt_from_jax_writer_loads_bit_exact(tmp_path):
    from stable_ts_tpu.models.whisper.load import load_openai_checkpoint as jax_load
    from stable_ts_tpu_torch.models.whisper.load import load_openai_checkpoint
    path, dims = _write_pt(tmp_path)
    got_dims, got = load_openai_checkpoint(path, device='cpu')
    ref_dims, ref_params = jax_load(path)
    assert vars(got_dims) == vars(ref_dims) == vars(dims)
    _assert_same_weights(got, _from_jax(ref_params, ref_dims))
    assert not any(p.requires_grad for p in got.parameters())


def test_port_writer_loads_in_jax_bit_exact(tmp_path):
    """The reverse direction: the port's writer, JAX's reader."""
    from stable_ts_tpu.models.whisper.load import load_openai_checkpoint as jax_load
    from stable_ts_tpu_torch.models.whisper.load import (load_openai_checkpoint,
                                                         save_openai_checkpoint)
    path, _ = _write_pt(tmp_path)
    dims, model = load_openai_checkpoint(path, device='cpu')
    out = str(tmp_path / 'rewritten.pt')
    save_openai_checkpoint(out, dims, model)
    assert sorted(_state_dict(out)) == sorted(_state_dict(path))
    ref_dims, ref_params = jax_load(out)
    assert vars(ref_dims) == vars(dims)
    _assert_same_weights(model, _from_jax(ref_params, ref_dims))


def test_bf16_checkpoint_widens_to_f32_as_jax(tmp_path):
    from stable_ts_tpu.models.whisper.load import load_openai_checkpoint as jax_load
    from stable_ts_tpu_torch.models.whisper.load import load_openai_checkpoint
    path, dims = _write_pt(tmp_path)
    bf16 = str(tmp_path / 'tiny-bf16.pt')
    torch.save({'dims': vars(dims), 'model_state_dict': {
        k: v.to(torch.bfloat16) for k, v in _state_dict(path).items()}}, bf16)
    _, got = load_openai_checkpoint(bf16, dtype=None, device='cpu')
    ref_dims, ref_params = jax_load(bf16)
    ref = _from_jax(ref_params, ref_dims)
    assert ref.decoder.token_emb.dtype == torch.float32
    _assert_same_weights(got, ref)


def test_bf16_model_from_f32_checkpoint_matches_jax(tmp_path):
    """dtype=torch.bfloat16 rounds the f32 weights as JAX's WhisperTPU
    (dtype=jnp.bfloat16) does."""
    import jax.numpy as jnp
    from stable_ts_tpu.loaders import load_model as jax_load_model
    from stable_ts_tpu_torch import load_model
    path, dims = _write_pt(tmp_path)
    got = load_model(path, dtype=torch.bfloat16, device='cpu')
    ref = jax_load_model(path, dtype=jnp.bfloat16)
    assert got.params.decoder.token_emb.dtype == torch.bfloat16
    _assert_same_weights(got.params, _from_jax(ref.params, ref.dims))


def test_missing_positional_embedding_is_sinusoids(tmp_path):
    from stable_ts_tpu.models.whisper.load import convert_openai_state_dict as jax_convert
    from stable_ts_tpu_torch.models.whisper.load import convert_openai_state_dict
    path, dims = _write_pt(tmp_path)
    sd = _state_dict(path)
    del sd['encoder.positional_embedding']
    got = convert_openai_state_dict(sd, _port_dims(dims), device='cpu')
    _assert_same_weights(got, _from_jax(jax_convert(sd, dims), dims))


def test_state_dict_names_and_shapes_are_checked(tmp_path):
    from stable_ts_tpu_torch.models.whisper.load import convert_openai_state_dict
    path, dims = _write_pt(tmp_path)
    sd = _state_dict(path)
    extra = dict(sd, **{'decoder.unknown': torch.zeros(1)})
    with pytest.raises(ValueError, match='unexpected'):
        convert_openai_state_dict(extra, _port_dims(dims), device='cpu')
    missing = {k: v for k, v in sd.items() if k != 'decoder.ln.bias'}
    with pytest.raises(ValueError, match='missing'):
        convert_openai_state_dict(missing, _port_dims(dims), device='cpu')
    bad = dict(sd, **{'decoder.ln.bias': torch.zeros(3)})
    with pytest.raises(ValueError, match='shape'):
        convert_openai_state_dict(bad, _port_dims(dims), device='cpu')


@pytest.mark.parametrize('shards', [1, 2], ids=['one_file', 'two_shards'])
def test_hf_directory_matches_jax(tmp_path, shards):
    from stable_ts_tpu.models.whisper.load import load_hf_checkpoint as jax_load
    from stable_ts_tpu_torch.models.whisper.load import (is_mlx_checkpoint_dir,
                                                         load_hf_checkpoint)
    path, dims = _write_pt(tmp_path)
    hdir = _write_hf_dir(tmp_path, path, dims, shards=shards)
    assert len([f for f in os.listdir(hdir) if f.endswith('.safetensors')]) == shards
    assert not is_mlx_checkpoint_dir(hdir)
    got_dims, got = load_hf_checkpoint(hdir, device='cpu')
    ref_dims, ref_params = jax_load(hdir)
    assert vars(got_dims) == vars(ref_dims) == vars(dims)
    _assert_same_weights(got, _from_jax(ref_params, ref_dims))


@pytest.mark.parametrize('key', ['model.encoder.layers.3.self_attn.q_proj.weight',
                                 'model.decoder.layers.0.encoder_attn_layer_norm.bias',
                                 'model.decoder.layers.1.fc2.weight',
                                 'model.decoder.embed_tokens.weight',
                                 'model.encoder.embed_positions.weight',
                                 'model.encoder.layer_norm.weight'])
def test_hf_key_map_equals_jax(key):
    from stable_ts_tpu.models.whisper.load import hf_key_to_openai as jax_map
    from stable_ts_tpu_torch.models.whisper.load import hf_key_to_openai
    assert hf_key_to_openai(key) == jax_map(key)


def test_mlx_directory_matches_jax(tmp_path):
    from stable_ts_tpu.models.whisper.load import load_mlx_checkpoint as jax_load
    from stable_ts_tpu_torch.models.whisper.load import (is_mlx_checkpoint_dir,
                                                         load_mlx_checkpoint)
    path, dims = _write_pt(tmp_path)
    mdir = _write_mlx_dir(tmp_path, path, dims)
    assert is_mlx_checkpoint_dir(mdir)
    got_dims, got = load_mlx_checkpoint(mdir, device='cpu')
    ref_dims, ref_params = jax_load(mdir)
    assert vars(got_dims) == vars(ref_dims) == vars(dims)
    _assert_same_weights(got, _from_jax(ref_params, ref_dims))


def test_quantized_mlx_directory_raises(tmp_path):
    from stable_ts_tpu_torch.models.whisper.load import load_mlx_checkpoint
    mdir = tmp_path / 'q'
    os.makedirs(mdir)
    with open(mdir / 'config.json', 'w') as f:
        json.dump({**vars(_jax_dims_params()[0]),
                   'quantization': {'group_size': 64, 'bits': 4}}, f)
    with pytest.raises(NotImplementedError, match='quantized'):
        load_mlx_checkpoint(str(mdir), device='cpu')


@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file
    from stable_ts_tpu_torch.models.whisper.load import read_safetensors
    rng = np.random.default_rng(5)
    tensors = {'a': rng.standard_normal((3, 5)).astype(dtype),
               'b.c': rng.standard_normal((7,)).astype(dtype),
               'scalar': np.asarray(rng.standard_normal(), dtype),
               'empty': np.zeros((0, 4), dtype)}
    path = str(tmp_path / 'x.safetensors')
    save_file(tensors, path, metadata={'format': 'np'})
    got = read_safetensors(path)
    ref = load_file(path)
    assert sorted(got) == sorted(ref)
    for name, arr in ref.items():
        assert got[name].numpy().dtype == arr.dtype, name
        assert got[name].shape == arr.shape, name
        assert np.array_equal(got[name].numpy(), arr), name


def test_safetensors_reader_refuses_non_float_tensors(tmp_path):
    from safetensors.numpy import save_file
    from stable_ts_tpu_torch.models.whisper.load import read_safetensors
    path = str(tmp_path / 'ints.safetensors')
    save_file({'ids': np.arange(6, dtype=np.int32)}, path)
    with pytest.raises(ValueError, match='unsupported dtype I32'):
        read_safetensors(path)


def test_safetensors_reader_bf16_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file
    from stable_ts_tpu_torch.models.whisper.load import read_safetensors
    gen = torch.Generator().manual_seed(6)
    tensors = {'w': torch.randn(4, 9, generator=gen).to(torch.bfloat16),
               'v': torch.randn(11, generator=gen).to(torch.bfloat16),
               'f': torch.randn(2, 2, generator=gen)}
    path = str(tmp_path / 'bf16.safetensors')
    save_file(tensors, path)
    got = read_safetensors(path)
    ref = load_file(path)
    assert sorted(got) == sorted(ref)
    for name, t in ref.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def _write_tiktoken(path, ranks):
    import base64
    with open(path, 'w') as f:
        for token, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(f'{base64.b64encode(token).decode()} {rank}\n')


def test_load_model_by_name_in_download_root(tmp_path, monkeypatch):
    """A name resolves inside download_root; the canonical heads come from
    the name (tiny dims have no entry of that shape, so they stay None),
    and a vocabulary beside the checkpoint is found."""
    from stable_ts_tpu_torch import load_model
    from stable_ts_tpu_torch.models.whisper.tokenizer import synthetic_byte_ranks
    monkeypatch.delenv('STABLE_TS_TPU_VOCAB_DIR', raising=False)
    path, _ = _write_pt(tmp_path, name='mymodel.pt')
    _write_tiktoken(tmp_path / 'multilingual.tiktoken', synthetic_byte_ranks())
    model = load_model('mymodel', download_root=str(tmp_path), device='cpu')
    assert model.name == 'mymodel.pt' and model.device == torch.device('cpu')
    assert model.alignment_heads is None
    assert model._vocab_path == str(tmp_path / 'multilingual.tiktoken')
    assert model.get_tokenizer('en').bpe.ranks == synthetic_byte_ranks()
    monkeypatch.setenv('STABLE_TS_TPU_MODELS', str(tmp_path))
    assert load_model('mymodel', device='cpu').name == 'mymodel.pt'


def test_load_model_known_name_takes_the_canonical_heads(tmp_path):
    """A file named after a catalog model whose shape matches gets that
    model's heads, as JAX's load_model gives them."""
    from stable_ts_tpu.loaders import load_model as jax_load_model
    from stable_ts_tpu_torch import load_model
    from stable_ts_tpu_torch.models.whisper.alignment_heads import get_alignment_heads
    from stable_ts_tpu_torch.models.whisper.tokenizer import synthetic_byte_ranks
    # tiny.en's table is (4 layers, 6 heads): narrow dims of that shape
    path, _ = _write_pt(tmp_path, name='tiny.en.pt', n_text_layer=4, n_text_head=6,
                        n_audio_head=6, n_audio_state=48, n_text_state=48,
                        n_vocab=51864)
    vocab = str(tmp_path / 'gpt2.tiktoken')
    _write_tiktoken(vocab, synthetic_byte_ranks())
    got = load_model(path, device='cpu')
    ref = jax_load_model(path, vocab_path=vocab)
    assert got.alignment_heads == get_alignment_heads('tiny.en', 4, 6)
    assert got.alignment_heads == ref.alignment_heads and got.alignment_heads
    assert got._vocab_path == vocab


def test_load_model_missing_checkpoint_and_vocabulary_raise(tmp_path, monkeypatch):
    from stable_ts_tpu_torch import load_model
    monkeypatch.delenv('STABLE_TS_TPU_VOCAB_DIR', raising=False)
    monkeypatch.delenv('STABLE_TS_TPU_MODELS', raising=False)
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    with pytest.raises(FileNotFoundError, match='checkpoint not found'):
        load_model('no-such-model', download_root=str(tmp_path), device='cpu')
    path, _ = _write_pt(tmp_path, name='big-vocab.pt', n_vocab=51865)
    with pytest.raises(FileNotFoundError, match='vocabulary'):
        load_model(path, device='cpu')


def test_modify_model_passes_the_port_through_and_rejects_others(tmp_path):
    """A WhisperTorch passes through; a faster-whisper model gains the
    stabilized methods in place; anything else raises."""
    from stable_ts_tpu_torch import load_test_model, modify_model

    class FakeFasterWhisper:
        model = object()
        feature_extractor = object()

        def transcribe(self, audio, **options):
            raise AssertionError('not called')

    model = load_test_model(device='cpu')
    assert modify_model(model) is model
    with pytest.raises(TypeError, match='WhisperTorch'):
        modify_model(object())
    fw = FakeFasterWhisper()
    assert modify_model(fw) is fw
    assert fw.transcribe_original.__func__ is FakeFasterWhisper.transcribe
    for name in ('transcribe', 'transcribe_stable', 'align', 'align_words', 'refine'):
        assert getattr(fw, name).__self__ is fw, name
    assert not hasattr(fw, 'locate')


def test_dq_model_is_not_written(tmp_path):
    from stable_ts_tpu_torch import load_test_model
    from stable_ts_tpu_torch.models.whisper.load import save_openai_checkpoint
    model = load_test_model(device='cpu', dq=True)
    with pytest.raises(ValueError, match='dq'):
        save_openai_checkpoint(str(tmp_path / 'dq.pt'), model.dims, model.params)


@pytest.mark.parametrize('layout', ['openai_pt', 'hf_dir', 'mlx_dir'])
def test_transcribe_from_loaded_checkpoint_matches_jax(tmp_path, layout, monkeypatch):
    monkeypatch.setenv('STABLE_TS_TPU_CROSS', 'interpret')
    monkeypatch.setenv('STABLE_TS_TPU_SELFKV', '1')
    monkeypatch.setenv('STABLE_TS_TPU_EPI', '0')
    from stable_ts_tpu.loaders import load_model as jax_load_model
    from stable_ts_tpu_torch import load_model
    path, dims = _write_pt(tmp_path, seed=0)
    if layout == 'hf_dir':
        path = _write_hf_dir(tmp_path, path, dims)
    elif layout == 'mlx_dir':
        path = _write_mlx_dir(tmp_path, path, dims)
    ref_model = jax_load_model(path, alignment_heads=[(0, 1), (1, 0), (1, 1)])
    got_model = load_model(path, alignment_heads=[(0, 1), (1, 0), (1, 1)],
                           device='cpu')
    audio = (np.random.default_rng(21).standard_normal(16000 * 20) * 0.1
             ).astype(np.float32)
    kw = dict(language='en', temperature=0, verbose=None)
    ref = ref_model.transcribe(audio, **kw)
    got = got_model.transcribe(audio, **kw)
    assert got.text == ref.text and len(ref.segments) > 0
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
