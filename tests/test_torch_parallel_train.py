"""The port's dp x tp train step against JAX's sharded one, on the CPU.

A gloo world of four ranks (tests/torch_parallel_worker.py; no jax and no
stable_ts_tpu module loads there, which is asserted) takes two train steps
on a (dp 2, tp 2) mesh: each rank its two of the batch's four rows and
its half of the heads, the gradients summed over dp, AdamW on the local
shards. The same ranks take two unsharded steps from the same weights.
Meanwhile this process runs JAX's ``make_train_step`` under jit on
``build_mesh(n_devices=4, tp=2)`` of the conftest's 8-device CPU mesh, as
__graft_entry__.py:86-109 does, on the config there (4 heads). The losses
must agree within 1e-5 relative and every updated f32 parameter, gathered
over tp, within 1e-6 absolute.
"""
import numpy as np
import pytest

from test_torch_parallel import World, _numpy_tree

STEPS = 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6


def _dims():
    from stable_ts_tpu.models.whisper.model import ModelDimensions
    return ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
        n_audio_layer=2, n_vocab=1864, n_text_ctx=448, n_text_state=64,
        n_text_head=4, n_text_layer=2)


@pytest.fixture(scope='module')
def batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 80, 3000)).astype(np.float32),
            rng.integers(0, 1800, (4, 16)).astype(np.int32))


@pytest.fixture(scope='module')
def world(tmp_path_factory, batch):
    from stable_ts_tpu.models.whisper.model import init_params
    dims = _dims()
    mel, tokens = batch
    inputs = dict(train_dims=dict(vars(dims)),
                  train_params=_numpy_tree(init_params(dims, seed=0)),
                  train_mel=mel, train_tokens=tokens, train_steps=STEPS)
    return World(tmp_path_factory.mktemp('parallel_train'), 4, 2, ['train'],
                 inputs)


@pytest.fixture(scope='module')
def jax_steps(world, batch):
    """JAX's losses and weights after the sharded steps, as the port's
    numpy state dict."""
    import jax
    from stable_ts_tpu.models.whisper.model import init_params
    from stable_ts_tpu.models.whisper.train import make_train_step
    from stable_ts_tpu.parallel.mesh import (build_mesh, data_sharding,
                                             param_shardings)
    from stable_ts_tpu_torch.models.whisper.convert import jax_state_dict
    dims = _dims()
    mesh = build_mesh(n_devices=4, tp=2)
    params = jax.tree.map(jax.device_put, init_params(dims, seed=0),
                          param_shardings(mesh, dims))
    init_opt, train_step = make_train_step(dims)
    opt_state = init_opt(params)
    mel, tokens = batch
    mel = jax.device_put(mel, data_sharding(mesh, 3))
    tokens = jax.device_put(tokens, data_sharding(mesh, 2))
    step = jax.jit(train_step)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, mel, tokens)
        losses.append(float(loss))
    return losses, jax_state_dict(_numpy_tree(params), dims)


def _train(world, rank=0):
    res = world.results()[rank]['train']
    assert 'error' not in res, res.get('error')
    return res


def test_losses_match_jax_sharded(world, jax_steps):
    losses, _ = jax_steps
    assert _train(world)['sharded']['losses'] == pytest.approx(losses,
                                                               rel=LOSS_RTOL)


def test_params_match_jax_sharded(world, jax_steps):
    _, ref = jax_steps
    got = _train(world)['sharded']['params']
    assert set(got) == set(ref)
    worst = max(float(np.abs(got[n] - ref[n]).max()) for n in ref)
    assert worst <= PARAM_ATOL, worst


def test_sharded_step_matches_the_unsharded_port(world):
    res = _train(world)
    assert res['sharded']['losses'] == pytest.approx(res['plain']['losses'],
                                                     rel=LOSS_RTOL)
    got, ref = res['sharded']['params'], res['plain']['params']
    assert max(float(np.abs(got[n] - ref[n]).max()) for n in ref) <= PARAM_ATOL


def test_every_rank_returns_the_global_loss(world):
    losses = [_train(world, r)['sharded']['losses'] for r in range(4)]
    assert all(l == losses[0] for l in losses)


def test_ranks_load_no_jax(world):
    assert all(res['modules'] == [] for res in world.results())
