"""The port's multi-GPU layer (stable_ts_tpu_torch/parallel/) on the CPU:
the counterparts of tests/test_parallel_inference.py in gloo worlds of
processes, the way the port runs on GPUs (one process a device).

Two worlds start once for the module (tests/torch_parallel_worker.py):
four ranks on a (dp 2, tp 2) mesh, and two on (dp 2, tp 1). Their ranks
import neither jax nor stable_ts_tpu, which is asserted; they load JAX's
``load_test_model`` weights (2 heads, so tp = 2 really splits them) from
numpy through ``convert.from_jax_params``. While they run, this process
runs JAX's own sharded model on ``build_mesh(n_devices=4, tp=2)`` of the
conftest's 8-device CPU mesh, with the int8 self cache the port keeps
(``STABLE_TS_TPU_SELFKV=1``). At ``temperature=0`` the port's sharded
``transcribe_batched`` (greedy, beam 2, ``dq`` at tp = 2), ``align``,
``align_words`` (parallel) and ``refine`` (parallel) must give JAX's
sharded text with every word start within 0.021 s (JAX's own tolerance),
and the unsharded port's; so must ``locate`` (modes 0 and 1) and, on the
dp world, a ``best_of`` ladder whose every window is sampled. Besides: the mesh and the placement of the
weight shards, ``shard_batch``'s padding, ``dq``'s int8 cross K/V and
self-cache codes equal to the unsharded port's (the amax all-reduce), a
temperature-0.8 ``best_of`` decode whose draws do not change with dp,
and an out-of-memory error that makes every rank halve the batch: on one
rank of the dp world before its decode, and on the two ranks of one tp
group of the dp x tp world inside a decode step.
"""
import os
import pickle
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]
TIME_TOL = 0.021
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_parallel_worker.py')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _numpy_tree(params):
    """A JAX param pytree as numpy, quantized leaves as (q, scale)
    namespaces, which ``convert.from_jax_params`` reads."""
    import jax
    from stable_ts_tpu.models.whisper.quantization import QuantizedArray

    def leaf(x):
        if isinstance(x, QuantizedArray):
            return types.SimpleNamespace(q=np.asarray(x.q),
                                         scale=np.asarray(x.scale))
        return np.array(x)
    return jax.tree.map(leaf, params,
                        is_leaf=lambda x: isinstance(x, QuantizedArray))


class World:
    """``world`` worker processes on a free local port, started now and
    joined by :meth:`results`."""

    def __init__(self, root, world: int, tp: int, checks, inputs):
        os.makedirs(root, exist_ok=True)
        self.root, self.world = str(root), world
        job = os.path.join(self.root, 'job.pkl')
        with open(job, 'wb') as f:
            pickle.dump(dict(world=world, port=_free_port(), tp=tp,
                             checks=checks, inputs=inputs, out=self.root), f)
        env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
        env.update(OMP_NUM_THREADS='1', CUDA_VISIBLE_DEVICES='')
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, job, str(rank)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
        self._results = None

    def results(self, timeout: float = 600):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            out = []
            for rank, (p, log) in enumerate(zip(self.procs, logs)):
                path = os.path.join(self.root, f'rank{rank}.pkl')
                assert p.returncode == 0 and os.path.exists(path), log[-4000:]
                with open(path, 'rb') as f:
                    out.append(pickle.load(f))
            self._results = out
        return self._results


@pytest.fixture(scope='module', autouse=True)
def jax_env():
    """JAX as the port's other parity tests run it on the CPU: the int8
    self cache (the port's), the cross kernel in interpret mode, the
    greedy epilogue off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('STABLE_TS_TPU_CROSS', 'interpret')
        mp.setenv('STABLE_TS_TPU_SELFKV', '1')
        mp.setenv('STABLE_TS_TPU_EPI', '0')
        yield


@pytest.fixture(scope='module')
def audio():
    rng = np.random.default_rng(21)
    return (rng.standard_normal(SR * 70) * 0.1).astype(np.float32)


@pytest.fixture(scope='module')
def jax_models():
    import jax.numpy as jnp
    from stable_ts_tpu.loaders import load_test_model
    plain = load_test_model(alignment_heads=HEADS)
    dq = load_test_model(alignment_heads=HEADS, dq=True, dtype=jnp.float32)
    return plain, dq


@pytest.fixture(scope='module')
def worlds(tmp_path_factory, audio, jax_models):
    plain, dq = jax_models
    inputs = dict(dims=dict(vars(plain.dims)), ranks=plain._ranks,
                  heads=HEADS, params=_numpy_tree(plain.params),
                  params_dq=_numpy_tree(dq.params), audio=audio,
                  mel=np.random.default_rng(8).standard_normal(
                      (4, 80, 3000)).astype(np.float32))
    root = tmp_path_factory.mktemp('parallel')
    four = World(root / 'four', 4, 2, ['placement', 'shard_batch', 'greedy',
                                       'beam2', 'dq', 'align', 'align_words',
                                       'refine', 'no_heads', 'locate', 'oom_tp'],
                 inputs)
    two = World(root / 'two', 2, 1, ['shard_batch', 'sampling', 'best_of', 'oom'],
                inputs)
    return four, two


@pytest.fixture(scope='module')
def jax_sharded(worlds, audio, jax_models):
    """JAX's results on its (dp 2, tp 2) mesh, computed while the worlds
    run. The mesh turns JAX's fused kernels off process-wide: they are
    turned back on, and the traces made meanwhile dropped, afterwards."""
    import jax
    from stable_ts_tpu.models.whisper import model as model_mod
    from stable_ts_tpu.parallel.mesh import build_mesh
    plain, dq = jax_models
    was_on = model_mod.fused_kernels_enabled()
    try:
        plain.shard(build_mesh(n_devices=4, tp=2))
        dq.shard(build_mesh(n_devices=4, tp=2))
        segs = [dict(start=4.0 * i, end=4.0 * (i + 1),
                     text=f' word{i} and more{i}') for i in range(6)]
        short, a20, a12 = audio[:SR * 35], audio[:SR * 20], audio[:SR * 12]
        base = plain.align(a12, ' hello world refine me', language='en',
                           verbose=None)
        out = dict(
            greedy=plain.transcribe_batched(short, temperature=0, verbose=None),
            beam2=plain.transcribe_batched(a20, temperature=0, beam_size=2,
                                           verbose=None),
            dq=dq.transcribe_batched(a20, temperature=0, verbose=None),
            align=plain.align(a12, ' hello world this is a mesh test',
                              language='en', verbose=None),
            align_words=plain.align_words(audio[:SR * 24],
                                          [dict(s) for s in segs],
                                          language='en', verbose=None,
                                          parallel=True),
            refine=plain.refine(a12, base, inplace=False, parallel=True,
                                verbose=None))
    finally:
        model_mod.set_fused_kernels_enabled(was_on)
        jax.clear_caches()
    return {k: dict(text=r.text,
                    starts=[w.start for s in r.segments for w in s.words])
            for k, r in out.items()}


@pytest.fixture(scope='module')
def results(worlds, jax_sharded):
    """Each world's ranks' results, read once JAX's sharded runs are done
    (so that they run while the worlds do)."""
    return tuple(world.results() for world in worlds)


def _rank0(results, check):
    res = results[0][check]
    assert 'error' not in res, res.get('error')
    return res


def _same_words(got, ref):
    assert got['text'] == ref['text']
    assert len(got['starts']) == len(ref['starts'])
    assert got['starts'] == pytest.approx(ref['starts'], abs=TIME_TOL)


def test_mesh_and_placement(results):
    """dp 2 x tp 2; a column-split weight keeps N / tp rows on each rank,
    a row-split one K / tp columns with its whole bias, and the stack
    computes its rank's heads."""
    res = _rank0(results[0], 'placement')
    assert (res['dp'], res['tp']) == (2, 2)
    # JAX's _block_specs in the port's (out, in) layout: column splits on
    # dim 0, row splits on dim 1, their biases and the rest replicated
    assert res['n_specs'] == res['n_params']
    assert res['specs'] == {
        'encoder.blocks.0.attn.q.weight': 0, 'decoder.blocks.1.cross_attn.v.bias': 0,
        'decoder.blocks.0.mlp.fc2.weight': 1, 'encoder.blocks.1.attn.out.bias': None,
        'decoder.token_emb': None, 'encoder.conv1.weight': None,
        'decoder.ln.weight': None}
    assert res['shardings']['encoder.blocks.0.attn.q.weight'] == \
        '(Replicate(), Shard(dim=0))'
    assert res['shardings']['decoder.blocks.0.mlp.fc2.weight'] == \
        '(Replicate(), Shard(dim=1))'
    assert res['data'] == '(Shard(dim=0), Replicate())'
    assert res['q_rows'] == res['out_cols'] == res['width'] // 2
    assert res['out_bias'] == res['width']
    assert (res['n_head'], res['n_head_total']) == (1, 2)


@pytest.mark.parametrize('world', [0, 1], ids=['dp2_tp2', 'dp2_tp1'])
def test_shard_batch_pads_to_dp(results, world):
    """dp + 1 rows pad to 2 dp by repeating the last; each rank keeps its
    half, and the gather over dp gives the padded batch on every rank."""
    for rank, res in enumerate(results[world]):
        got = res['shard_batch']
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        padded = np.concatenate([arr, arr[-1:]])
        dp_rank = rank // (2 if world == 0 else 1)
        assert got['n'] == 3
        np.testing.assert_array_equal(got['local'], padded[2 * dp_rank:2 * dp_rank + 2])
        np.testing.assert_array_equal(got['gathered'], padded)


@pytest.mark.parametrize('case', ['greedy', 'beam2', 'dq', 'align',
                                  'align_words', 'refine'])
def test_sharded_port_matches_jax_sharded(results, jax_sharded, case):
    _same_words(_rank0(results[0], case)['sharded'], jax_sharded[case])


@pytest.mark.parametrize('case', ['greedy', 'beam2', 'dq', 'align',
                                  'align_words', 'refine', 'no_heads'])
def test_sharded_port_matches_unsharded_port(results, case):
    res = _rank0(results[0], case)
    _same_words(res['sharded'], res['plain'])


def test_every_rank_computes_the_same_result(results):
    four = results[0]
    for case in ('greedy', 'beam2', 'dq', 'align', 'align_words', 'refine',
                 'no_heads', 'locate'):
        assert all(r[case]['sharded'] == four[0][case]['sharded']
                   for r in four[1:]), case


def test_dq_cache_codes_equal_the_unsharded(results):
    """The cross K/V and self-cache rows are quantized over the whole d:
    the amax is all-reduced over tp, so the gathered codes and the scales
    equal the unsharded port's; a row-split weight keeps every scale."""
    res = _rank0(results[0], 'dq')
    assert res['cross_codes_equal'] and res['cross_scales_equal']
    assert res['self_codes_equal'] and res['self_scales_equal']
    assert res['row_scale_shape'] == (64,)


def test_sharded_locate_matches_unsharded_port(results):
    """Modes 0 and 1 find the same matches at the same times on the mesh
    (the estimate's capture gathered over tp, the confirmation decode
    over float caches of the rank's heads)."""
    res = _rank0(results[0], 'locate')
    assert res['sharded'] == res['plain']
    assert all(res['plain'])


def test_best_of_ladder_matches_unsharded_port_over_dp(results):
    """Every window falls back to temperature 0.4 with best_of=2: the
    sampled retries split over dp draw what the unsharded run draws."""
    res = _rank0(results[1], 'best_of')
    _same_words(res['sharded'], res['plain'])


def test_sampling_draws_do_not_change_with_dp(results):
    res = _rank0(results[1], 'sampling')
    assert res['sharded'] == res['plain']
    assert len(res['plain']) == 4 and all(len(t) for t in res['plain'])


def test_out_of_memory_on_one_rank_halves_every_rank(results):
    for res in results[1]:
        oom = res['oom']
        assert 'error' not in oom, oom.get('error')
        assert len(oom['warnings']) == 1
        assert 'batch_size=2' in oom['warnings'][0]
        assert oom['sharded'] == oom['plain']


def test_out_of_memory_in_a_tp_group_halves_every_rank(results):
    """dp row 0's tp group runs out of memory inside a decode step, after
    a tp all-reduce, while dp row 1 decodes on: all four ranks halve."""
    for rank, res in enumerate(results[0]):
        oom = res['oom_tp']
        assert 'error' not in oom, oom.get('error')
        assert oom['raised'] == (rank < 2)
        assert len(oom['warnings']) == 1
        assert 'batch_size=2' in oom['warnings'][0]
        assert oom['sharded'] == oom['plain']


@pytest.mark.parametrize('world', [0, 1], ids=['dp2_tp2', 'dp2_tp1'])
def test_ranks_load_no_jax(results, world):
    assert all(res['modules'] == [] for res in results[world])
