"""The port's train step against stable_ts_tpu's on the CPU: the flash
backward's twin against the VJP of the Pallas module's plain reference
(over the TPU's padding and segment ids), an f64 ``gradcheck`` of the
autograd function, the cross-entropy loss and every parameter's gradient,
AdamW against ``optax.adamw(1e-5)``, and whole train steps. Tiny dims, f32,
inputs from numpy seeds.

Tolerances state their reasons where they are used: f32 sums taken in
another order, and the port scaling the scores once by d_head^-0.5 where
JAX's CPU path scales q and k by d_head^-0.25 each."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stable_ts_tpu.models.whisper import model as jm
from stable_ts_tpu.models.whisper import train as jt
from stable_ts_tpu_torch.models.whisper.convert import (from_jax_params,
                                                        jax_state_dict)
from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
from stable_ts_tpu_torch.models.whisper.train import (adamw, cross_entropy_loss,
                                                      make_train_step)

torch.set_num_threads(2)
H = 2


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize('dh', [32, 64])
@pytest.mark.parametrize('t,s', [(100, 100), (37, 300), (1, 1500)])
def test_backward_twin_matches_pallas_reference_vjp(t, s, dh):
    """FlashAttention's backward (the twin on the CPU) against the VJP of
    ``mha_reference_no_custom_vjp`` on the TPU's layout: heads split, the
    sequences padded to 128 and masked with segment ids (model.py:259-263),
    dO zero on the pad rows; the real rows compared."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention
    rng = np.random.default_rng(t + s + dh)
    d = H * dh
    q, do = (rng.standard_normal((2, t, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, s, d)).astype(np.float32) for _ in range(2))
    tp, sp = -(-t // 128) * 128, -(-s // 128) * 128

    def heads(x, n):
        x = x.reshape(2, x.shape[1], H, dh).transpose(0, 2, 1, 3)
        return jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, n - x.shape[2]), (0, 0))))

    def seg(n, n_pad):
        return jnp.asarray(np.pad(np.ones((2, n), np.int32), ((0, 0), (0, n_pad - n)),
                                  constant_values=2))

    ids = SegmentIds(seg(t, tp), seg(s, sp))
    _, vjp = jax.vjp(lambda a, b, c: mha_reference_no_custom_vjp(
        a, b, c, segment_ids=ids, sm_scale=dh ** -0.5),
        heads(q, tp), heads(k, sp), heads(v, sp))
    refs = [np.asarray(g)[:, :, :n].transpose(0, 2, 1, 3).reshape(2, n, d)
            for g, n in zip(vjp(heads(do, tp)), (t, s, s))]

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    flash_attention(qt, kt, vt, H, dh ** -0.5).backward(torch.from_numpy(do))
    for name, got, ref in zip('qkv', (qt.grad, kt.grad, vt.grad), refs):
        # f32; the sums run in another order
        assert _rel_err(got.numpy(), ref) <= 1e-5, name


@pytest.mark.parametrize('t,s', [(5, 7), (1, 3), (6, 6)])
def test_flash_function_gradcheck(t, s):
    from stable_ts_tpu_torch.ops.flash_attn import FlashAttention
    gen = torch.Generator().manual_seed(t * 10 + s)
    q = torch.randn(2, t, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    k = torch.randn(2, s, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    v = torch.randn(2, s, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttention.apply(a, b, c, H, 0.5), (q, k, v))


def test_flash_function_respects_needs_input_grad():
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 64)).astype(np.float32))
               for n in (4, 9, 9))
    k.requires_grad_()
    out = flash_attention(q, k, v, H, 0.125)
    assert out.grad_fn is not None
    # an expanded dO (stride 0 after a .sum())
    out.sum().backward()
    assert k.grad is not None and q.grad is None and v.grad is None
    with torch.no_grad():
        assert flash_attention(q, k, v, H, 0.125).grad_fn is None


def test_vocab_logits_gives_the_tied_embedding_its_gradient():
    """A bf16 token embedding that requires grad gets the projection's
    gradient (x summed over rows, for a summed loss); with no gradient
    wanted the cached f32 copy gives the same logits."""
    from stable_ts_tpu_torch.models.whisper import model as pm
    import dataclasses
    dims = dataclasses.replace(tiny_test_dims(), n_text_layer=1, n_audio_layer=1)
    dec = pm.init_params(dims, seed=2, dtype=torch.bfloat16, device='cpu').decoder
    x = torch.randn((1, 3, 64), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    with torch.no_grad():
        cached = dec.vocab_logits(x)
    dec.token_emb.requires_grad_(True)
    logits = dec.vocab_logits(x)
    assert torch.equal(logits.detach(), cached)
    logits.sum().backward()
    want = x.float().sum((0, 1)).expand(dims.n_vocab, -1).to(torch.bfloat16)
    assert torch.equal(dec.token_emb.grad, want)


@pytest.fixture(scope='module')
def tiny():
    """Tiny JAX params and the port's model with the same weights, a
    seeded batch of two mels and 12 tokens, and a label mask."""
    dims = tiny_test_dims()
    params = jm.init_params(jm.tiny_test_dims(), seed=3)
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, 80, 3000)).astype(np.float32)
    tokens = rng.integers(0, dims.n_vocab, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[:, :3] = 0
    mask[1, 9:] = 0
    return dims, params, mel, tokens, mask


@pytest.mark.parametrize('masked', [False, True], ids=['mean', 'label_mask'])
def test_cross_entropy_loss_and_grads_match_jax(tiny, masked):
    dims, params, mel, tokens, mask = tiny
    label_mask = mask if masked else None
    loss_ref, grads = jax.value_and_grad(jt.cross_entropy_loss)(
        params, jnp.asarray(mel), jnp.asarray(tokens), dims,
        None if label_mask is None else jnp.asarray(label_mask))
    model = from_jax_params(params, dims, device='cpu').requires_grad_(True)
    loss = cross_entropy_loss(model, torch.from_numpy(mel),
                              torch.from_numpy(tokens).long(),
                              None if label_mask is None else torch.from_numpy(label_mask))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    ref = jax_state_dict(grads, dims)
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        # f32 sums in another order, and the score scaling (module doc)
        assert _rel_err(p.grad.numpy(), ref[name]) <= 1e-4, name


def test_adamw_matches_optax(tiny):
    """The default optimizer against optax.adamw(1e-5), fed the same
    gradients for 3 steps: each step's update within 1e-4 of its largest
    entry (f32; the two order the same arithmetic differently). The leaves
    are scaled to ~1e-3 so that the f32 parameters' own rounding (one ulp
    of p against an update of ~lr) stays far below that."""
    _, params, *_ = tiny
    rng = np.random.default_rng(11)
    leaves = {'w': np.asarray(params['decoder']['token_emb']) * 0.05,
              'b': rng.standard_normal(64).astype(np.float32) * 1e-3,
              'g': np.asarray(params['decoder']['ln']['g']) * 1e-3}
    ref_params = {n: jnp.asarray(a) for n, a in leaves.items()}
    port = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in leaves.items()}
    tx = optax.adamw(1e-5)
    state = tx.init(ref_params)
    opt = adamw(list(port.values()))
    for _ in range(3):
        grads = {n: rng.standard_normal(a.shape).astype(np.float32) * 0.01
                 for n, a in leaves.items()}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                   state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        before = {n: p.detach().clone() for n, p in port.items()}
        for n, p in port.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        for n, p in port.items():
            assert p.dtype == torch.float32
            assert _rel_err((p.detach() - before[n]).numpy(), np.asarray(updates[n])) <= 1e-4, n
            assert opt.state[p]['exp_avg'].dtype == p.dtype


def test_train_steps_match_jax(tiny):
    """Three steps of make_train_step on both, the second with a label
    mask: the losses within 1e-4 relative."""
    dims, params, mel, tokens, mask = tiny
    init_ref, step_ref = jt.make_train_step(dims)
    ref_params, state = params, init_ref(params)
    init, step = make_train_step(dims)
    model = from_jax_params(params, dims, device='cpu')
    opt = init(model)
    assert all(p.requires_grad for p in model.parameters())
    for i in range(3):
        m = mask if i == 1 else None
        ref_params, state, loss_ref = step_ref(
            ref_params, state, jnp.asarray(mel), jnp.asarray(tokens),
            None if m is None else jnp.asarray(m))
        loss = step(model, opt, mel, tokens, m)
        assert abs(loss.item() - float(loss_ref)) <= 1e-4 * abs(float(loss_ref)), i


def test_train_steps_lower_the_loss(tiny):
    """Ten steps on one batch at lr 1e-3: the loss falls."""
    dims, params, mel, tokens, _ = tiny
    init, step = make_train_step(
        dims, optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3))
    model = from_jax_params(params, dims, device='cpu')
    opt = init(model)
    losses = [step(model, opt, mel, tokens).item() for _ in range(10)]
    assert losses[-1] < 0.9 * losses[0], losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_train_step_refuses_a_quantized_model():
    from stable_ts_tpu_torch.loaders import load_test_model
    dq = load_test_model(seed=0, device='cpu', dq=True).params
    init, step = make_train_step(dq.dims)
    with pytest.raises(ValueError, match='dq'):
        init(dq)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    with pytest.raises(ValueError, match='dq'):
        step(dq, opt, np.zeros((1, 80, 3000), np.float32), np.zeros((1, 4), np.int64))
