"""The train step of the port (counterpart of stable_ts_tpu/models/whisper/
train.py): teacher-forced next-token cross-entropy over the decoder, and
AdamW.

    init_opt_state, train_step = make_train_step(dims)
    opt = init_opt_state(model)        # turns requires_grad on; the optimizer
    loss = train_step(model, opt, mel, tokens, label_mask=None)

The gradient runs through the same applies as inference: the encoder's
self-attention and the decoder's cross-attention through the flash kernels
(``ops/flash_attn.py``: the forward keeps each row's logsumexp, the two
backward kernels recompute the scores from it), the rest through PyTorch's
autograd. Unlike JAX's pure step, ``train_step`` updates the model's
parameters and the optimizer's state in place and returns only the loss.

On a (dp, tp) mesh (``parallel.shard_params``; the step of
__graft_entry__.py:86-109) every rank passes the same global batch and
takes its dp share of the rows. Its loss is its rows' summed NLL over the
global count, so the gradients summed over dp are the global mean's; the
tp gradients come from the tensor-parallel linears' autograd functions;
AdamW updates each rank's shards, elementwise as JAX's global update. The
returned loss is the global one.
"""
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from ...parallel.mesh import split_batch
from .dims import ModelDimensions
from .model import Whisper, decoder_apply, encoder_apply
from .quantization import is_quantized


def cross_entropy_loss(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
                       label_mask: Optional[torch.Tensor] = None,
                       denominator=None) -> torch.Tensor:
    """Teacher-forced next-token CE over the decoder (train.py:19-32).
    mel (B, n_mels, 3000); tokens (B, T) int; label_mask (B, T) or None.
    Returns the 0-d f32 NLL of tokens[:, 1:] (over the mask's positions
    [:, 1:] when one is given) summed and divided by ``denominator``:
    by default the count of those positions, so the mean; a dp rank
    passes the global batch's count."""
    xa = encoder_apply(model.encoder, mel)
    logits, _ = decoder_apply(model.decoder, tokens[:, :-1], xa)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, tokens[:, 1:, None])[..., 0]
    if label_mask is not None:
        nll = nll * label_mask[:, 1:].float()
    if denominator is None:
        denominator = _count(nll, label_mask)
    return nll.sum() / denominator


def _count(targets: torch.Tensor, label_mask) -> torch.Tensor:
    """The 0-d count of predicted positions: the ones of
    ``label_mask[:, 1:]`` (at least 1), else the elements of ``targets``
    (B, T - 1)."""
    if label_mask is not None:
        return label_mask[:, 1:].float().sum().clamp_min(1.0)
    return torch.tensor(float(targets.numel()))


def adamw(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """``optax.adamw(1e-5)`` in torch: its b1, b2, eps and weight decay
    (1e-4; torch's own default is 1e-2). Optax's update
    p - lr (m_hat / (sqrt(v_hat) + eps) + wd p) is torch's decoupled one;
    the moments stay in the parameters' dtype, as optax's mu_dtype=None."""
    return torch.optim.AdamW(params, lr=1e-5, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(dims: ModelDimensions,
                    optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None):
    """(init_opt_state, train_step), as the JAX package's make_train_step.
    ``optimizer``: a factory from the parameters to a torch optimizer
    (default :func:`adamw`). Every parameter is trained, ``encoder.pos_emb``
    included (a leaf of JAX's pytree too). A model of other dims, or a
    quantized (``dq``) one, is refused: JAX trains the float pytree."""
    factory = adamw if optimizer is None else optimizer

    def _check_model(model):
        if model.dims != dims:
            raise ValueError(f'model dims {model.dims} != {dims}')
        if is_quantized(model):
            raise ValueError('train_step takes a float model; this one has '
                             'int8 (dq) linears')

    def init_opt_state(model: Whisper) -> torch.optim.Optimizer:
        _check_model(model)
        model.requires_grad_(True)
        return factory(list(model.parameters()))

    def train_step(model: Whisper, opt: torch.optim.Optimizer, mel, tokens,
                   label_mask=None) -> torch.Tensor:
        """One step on (mel, tokens): the loss, its gradient and the
        optimizer's update, in place. Returns the 0-d f32 loss."""
        _check_model(model)
        device = model.decoder.token_emb.device
        mesh = model.mesh
        dp = 1 if mesh is None else mesh['dp'].size()
        tokens = torch.as_tensor(tokens)
        if tokens.shape[0] % dp:
            raise ValueError(f'a batch of {tokens.shape[0]} rows does not split '
                             f'over dp={dp}')
        if label_mask is not None:
            label_mask = torch.as_tensor(label_mask)
        # the global batch's count, then this rank's dp rows (all of them
        # without a dp split)
        denominator = _count(tokens[:, 1:], label_mask).to(device)
        mel = split_batch(mel, mesh, device)[0]
        tokens = split_batch(tokens, mesh, device)[0].long()
        if label_mask is not None:
            label_mask = split_batch(label_mask, mesh, device)[0]
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model, mel, tokens, label_mask, denominator)
        loss.backward()
        loss = loss.detach()
        if dp > 1:
            group = mesh.get_group('dp')
            for p in model.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
            dist.all_reduce(loss, group=group)
        opt.step()
        return loss

    return init_opt_state, train_step
