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
"""
from typing import Callable, Iterable, Optional

import torch

from .dims import ModelDimensions
from .model import Whisper, decoder_apply, encoder_apply
from .quantization import is_quantized


def cross_entropy_loss(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
                       label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced next-token CE over the decoder (train.py:19-32).
    mel (B, n_mels, 3000); tokens (B, T) int; label_mask (B, T) or None.
    Returns the 0-d f32 mean NLL of tokens[:, 1:] (over the mask's
    positions [:, 1:] when one is given)."""
    xa = encoder_apply(model.encoder, mel)
    logits, _ = decoder_apply(model.decoder, tokens[:, :-1], xa)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, tokens[:, 1:, None])[..., 0]
    if label_mask is not None:
        mask = label_mask[:, 1:].float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


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
        mel = torch.as_tensor(mel).to(device)
        tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.long)
        if label_mask is not None:
            label_mask = torch.as_tensor(label_mask).to(device)
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model, mel, tokens, label_mask)
        loss.backward()
        opt.step()
        return loss.detach()

    return init_opt_state, train_step
