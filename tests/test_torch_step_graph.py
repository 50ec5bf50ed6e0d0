"""The greedy step's CUDA graph on the CPU (``models/whisper/step_graph.py``).

The captured step takes its position as a 0-d tensor on the device: the
embedding, the cache-row write and the self-decode twin given one equal
what they give the int. The engagement rule sends every step but the
greedy step of an unsharded CUDA decoder to the eager path, so on the CPU
each decode step is counted eager and none is replayed. The graph itself
runs only on the card (``tests/test_torch_kernels_gpu.py``)."""
import types

import numpy as np
import pytest
import torch

from stable_ts_tpu_torch import profiling
from stable_ts_tpu_torch.models.whisper import decoding, step_graph
from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
from stable_ts_tpu_torch.models.whisper.model import (_embed, _write_rows,
                                                      init_params, quantize_rows)
from stable_ts_tpu_torch.ops.self_attn import self_attn_decode

torch.set_num_threads(2)
POSITIONS = [0, 1, 2, 127, 255]
B, C, D, N_HEAD = 3, 256, 64, 2


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope='module')
def decoder():
    return init_params(tiny_test_dims(), seed=3, device='cpu').decoder


@pytest.mark.parametrize('pos', POSITIONS)
def test_embed_takes_a_device_position(decoder, pos):
    tokens = torch.randint(0, 1000, (B, 1), generator=_gen(pos))
    want = _embed(decoder, tokens, offset=pos)
    assert torch.equal(_embed(decoder, tokens, offset=torch.tensor(pos)), want)


@pytest.mark.parametrize('int8', [True, False], ids=['int8_scales', 'float'])
@pytest.mark.parametrize('pos', POSITIONS)
def test_write_rows_takes_a_device_position(int8, pos):
    gen = _gen(pos)
    layers, layer = 2, 1
    if int8:
        cache = {'k': torch.zeros((layers, B, C, D), dtype=torch.int8),
                 'v': torch.zeros((layers, B, C, D), dtype=torch.int8),
                 'ks': torch.ones((layers, B, C)), 'vs': torch.ones((layers, B, C))}
    else:
        cache = {'k': torch.zeros((layers, B, C, D), dtype=torch.bfloat16),
                 'v': torch.zeros((layers, B, C, D), dtype=torch.bfloat16)}
    dtype = torch.float32 if int8 else torch.bfloat16
    k, v = (torch.randn((B, D), generator=gen).to(dtype) for _ in range(2))
    want = {n: t.clone() for n, t in cache.items()}
    _write_rows(want, layer, pos, k, v)
    _write_rows(cache, layer, torch.tensor(pos), k, v)
    for name in want:
        assert torch.equal(cache[name], want[name]), name
    assert want['k'][layer, :, pos].any()


@pytest.mark.parametrize('pos', POSITIONS)
def test_self_attn_decode_takes_a_device_position(pos):
    gen = _gen(pos)
    (k, ks), (v, vs) = (quantize_rows(torch.randn((B, C, D), generator=gen))
                        for _ in range(2))
    q = torch.randn((B, D), generator=gen) * (D // N_HEAD) ** -0.5
    want = self_attn_decode(q, k, v, ks, vs, pos, N_HEAD)
    got = self_attn_decode(q, k, v, ks, vs, torch.tensor(pos), N_HEAD)
    assert torch.equal(got, want)


def _stack(tp_group=None):
    return types.SimpleNamespace(tp_group=tp_group)


@pytest.mark.parametrize('device,decoder_tp,kwargs,graph', [
    ('cpu', None, dict(return_hidden=True), False),
    ('cuda', None, dict(return_hidden=True, anc=torch.zeros((1, 4), dtype=torch.int32)),
     False),
    ('cuda', None, dict(return_hidden=True, q_per_kv=5), False),
    ('cuda', object(), dict(return_hidden=True), False),
    ('cuda', None, dict(return_hidden=False), False),
    ('cuda', None, dict(return_hidden=True), True),
], ids=['cpu', 'anc', 'q_per_kv', 'tp_group', 'logits', 'greedy_cuda'])
def test_graph_engages_only_on_the_unsharded_cuda_greedy_step(device, decoder_tp,
                                                              kwargs, graph):
    got = step_graph.graphable(_stack(decoder_tp), torch.device(device), **kwargs)
    assert got is graph


@pytest.mark.parametrize('options', [dict(temperature=0.0), dict(temperature=0.5),
                                     dict(temperature=0.0, beam_size=2)],
                         ids=['greedy', 'sampled', 'beam'])
def test_cpu_decode_steps_are_all_eager(monkeypatch, options):
    """Every decoder step of a CPU decode is counted eager, none replayed,
    and no graph state is made on the decoder."""
    from stable_ts_tpu_torch import load_test_model
    model = load_test_model(device='cpu')
    calls = []
    real = decoding.decoder_step

    def counted(*args, **kwargs):
        calls.append(kwargs.get('graph'))
        return real(*args, **kwargs)
    monkeypatch.setattr(decoding, 'decoder_step', counted)
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, model.dims.n_mels, 3000)).astype(np.float32))
    with profiling.recording() as rec:
        model.decode(mel, language='en', sample_len=6, **options)
    assert calls and all(g is None for g in calls)
    assert rec.counters['decode.eager_steps'] == len(calls)
    assert rec.counters.get('decode.graph_replays', 0) == 0
    assert rec.counters.get('decode.graph_captures', 0) == 0
    assert model.params.decoder._step_graph is None
