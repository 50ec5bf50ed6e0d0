"""The (dp, tp) mesh, the sharding rules of the Whisper module tree, and the
batch split over ``dp`` (counterpart of stable_ts_tpu/parallel/mesh.py).

Axes, as in the JAX package:

- ``dp``: data parallel over a batch's rows (30-s windows, segments, spans);
- ``tp``: tensor parallel over attention heads and the MLP's hidden width.

The port's linear weights are (out, in), so JAX's column split of an
(in, out) weight's last axis is the split of dim 0 here, and its row split
is the split of dim 1.
"""
import os
import socket
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .tensor_parallel import ColumnParallelLinear, RowParallelLinear

_COLUMN = ('q', 'k', 'v', 'fc1')
_ROW = ('out', 'fc2')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the ``torch.distributed`` world: ``init_process_group`` over
    ``tcp://coordinator_address`` (host:port) with ``num_processes`` ranks,
    this one ``process_id``. With no address it reads ``torchrun``'s
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) and is a no-op
    when that is absent too, as on a single process. A no-op when a group
    exists. ``backend``: NCCL when CUDA is available, else gloo, unless
    given (gloo on CUDA tensors also works, one GPU shared by ranks). Under
    ``torchrun`` an NCCL rank takes GPU ``LOCAL_RANK``."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if not all(k in env for k in ('MASTER_ADDR', 'MASTER_PORT',
                                      'WORLD_SIZE', 'RANK')):
            return
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env['WORLD_SIZE']), int(env['RANK'])
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl' and 'LOCAL_RANK' in env:
        torch.cuda.set_device(int(env['LOCAL_RANK']))
    address = (coordinator_address if '://' in coordinator_address
               else f'tcp://{coordinator_address}')
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)


def build_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
               devices: Optional[str] = None) -> DeviceMesh:
    """A (dp, tp) ``DeviceMesh`` over the world's ranks (``n_devices``, if
    given, must be the world size). ``tp`` defaults to the largest of 4 and
    2 that divides the world, else 1, as the JAX package's. ``devices``:
    the mesh's device type, 'cuda' or 'cpu' (default: 'cuda' under NCCL,
    else 'cpu'). A process outside any world first starts a world of one
    on a free local port (NCCL for 'cuda', gloo otherwise)."""
    if not dist.is_initialized():
        if devices is None:
            devices = 'cuda' if torch.cuda.is_available() else 'cpu'
        distributed_init(f'127.0.0.1:{_free_port()}', 1, 0,
                         backend='nccl' if devices == 'cuda' else 'gloo')
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f'the mesh spans the whole world: n_devices={n} != '
                         f'world size {world}')
    if tp is None:
        tp = next((c for c in (4, 2) if n % c == 0), 1)
    if n % tp:
        raise ValueError(f'tp={tp} must divide device count {n}')
    if devices is None:
        devices = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(devices, torch.arange(n).reshape(n // tp, tp),
                      mesh_dim_names=('dp', 'tp'))


def _split_dim(name: str, heads: Dict[str, int], tp_size: int) -> Optional[int]:
    """The dim of parameter ``name`` split over tp, or None: replicated."""
    parts = name.split('.')
    if len(parts) < 3 or parts[1] != 'blocks' or heads[parts[0]] % tp_size:
        return None         # convs, embeddings, final LNs; JAX's fallback
    proj, leaf = parts[-2], parts[-1]
    if proj in _COLUMN:
        return 0            # weight rows, bias and scale: output channels
    if proj in _ROW and leaf == 'weight':
        return 1            # the bias and the per-output scale stay whole
    return None


def param_specs(dims, tp_size: int) -> Dict[str, Optional[int]]:
    """For every parameter of the :class:`~..models.whisper.model.Whisper`
    tree, the dim split over tp, or None when it is replicated (JAX's
    ``_block_specs``, mesh.py:57-105): q, k, v and fc1 and their biases by
    output channel, out and fc2 by input channel with their bias
    replicated, everything else replicated; a stack whose head count tp
    does not divide stays replicated. A dq model's per-output scales
    follow their weight's output channel (``shard_params``)."""
    from ..models.whisper.model import Whisper
    heads = {'encoder': dims.n_audio_head, 'decoder': dims.n_text_head}
    names = [n for n, _ in Whisper(dims, device='meta').named_parameters()]
    return {n: _split_dim(n, heads, tp_size) for n in names}


def param_shardings(mesh: DeviceMesh, dims) -> dict:
    """:func:`param_specs` as DTensor placements on ``mesh``: replicated
    over dp, ``Shard(dim)`` or replicated over tp."""
    from torch.distributed.tensor import Replicate, Shard
    specs = param_specs(dims, mesh['tp'].size())
    return {n: (Replicate(), Replicate() if d is None else Shard(d))
            for n, d in specs.items()}


def data_sharding(mesh: DeviceMesh, ndim: int) -> tuple:
    """The placements of a batch of ``ndim`` dims: rows split over dp,
    replicated over tp (:func:`split_batch` does the split)."""
    from torch.distributed.tensor import Replicate, Shard
    if ndim < 1:
        raise ValueError('a batch has a leading row axis')
    return (Shard(0), Replicate())


@torch.no_grad()
def shard_params(model, mesh: DeviceMesh, dims):
    """Keep this rank's tp shard of ``model``'s weights, in place, and wrap
    its linears in the tensor-parallel modules. A ``QuantizedLinear``
    keeps the int8 rows and the per-output scales of the whole weight,
    quantized before the split: a column split slices the int8 weight and
    its scales by output channel, a row split slices the weight by input
    channel and keeps every scale (JAX's ``scale_spec``, mesh.py:129-141).
    Each stack records its tp group (the int8 row amax and the head
    capture reduce over it), its local head count and its first head. With
    tp = 1 the weights stay whole and unwrapped, and no reduction runs (over
    one rank it is the identity, and each costs host time a step). Returns
    the model."""
    tp = mesh['tp'].size()
    rank = mesh.get_local_rank('tp')
    group = mesh.get_group('tp')
    heads = {'encoder': dims.n_audio_head, 'decoder': dims.n_text_head}
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    for name, t in tensors.items():
        dim = _split_dim(name, heads, tp)
        if dim is None or tp == 1:
            continue
        width = t.shape[dim] // tp
        local = t.narrow(dim, rank * width, width).clone()
        owner_name, leaf = name.rsplit('.', 1)
        owner = model.get_submodule(owner_name)
        if isinstance(t, torch.nn.Parameter):
            setattr(owner, leaf, torch.nn.Parameter(local,
                                                    requires_grad=t.requires_grad))
        else:
            owner.register_buffer(leaf, local)
    for stack_name, stack in (('encoder', model.encoder),
                              ('decoder', model.decoder)):
        if tp == 1 or heads[stack_name] % tp:
            continue      # replicated: every rank computes the whole stack
        stack.tp_group = group
        stack.n_head = heads[stack_name] // tp
        stack.head_offset = rank * stack.n_head
        for blk in stack.blocks:
            attns = [blk.attn] + ([blk.cross_attn] if hasattr(blk, 'cross_attn')
                                  else [])
            for attn in attns:
                for proj in ('q', 'k', 'v'):
                    setattr(attn, proj,
                            ColumnParallelLinear(getattr(attn, proj), group))
                attn.out = RowParallelLinear(attn.out, group)
            blk.mlp.fc1 = ColumnParallelLinear(blk.mlp.fc1, group)
            blk.mlp.fc2 = RowParallelLinear(blk.mlp.fc2, group)
    model.mesh = mesh
    return model


@torch.no_grad()
def full_state_dict(model, dims) -> Dict[str, torch.Tensor]:
    """The whole weights of a model that :func:`shard_params` split, under
    the unsharded model's names, on every rank: each tp-split tensor
    all-gathered over tp along its split dim."""
    mesh = model.mesh
    tp = 1 if mesh is None else mesh['tp'].size()
    heads = {'encoder': dims.n_audio_head, 'decoder': dims.n_text_head}
    out = {}
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        name = name.replace('.inner.', '.')
        dim = _split_dim(name, heads, tp)
        if dim is not None and tp > 1:
            parts = [torch.empty_like(t) for _ in range(tp)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group('tp'))
            t = torch.cat(parts, dim=dim)
        out[name] = t.detach()
    return out


# -- the batch split over dp ---------------------------------------------------------------

def batch_rows(n: int, mesh: Optional[DeviceMesh]) -> Tuple[int, int, int]:
    """(padded row count, first row, end row) of this rank's share of a
    batch of ``n`` rows: ``n`` rounded up to a dp multiple, split evenly."""
    if mesh is None:
        return n, 0, n
    dp = mesh['dp'].size()
    padded = -(-n // dp) * dp
    per = padded // dp
    lo = mesh.get_local_rank('dp') * per
    return padded, lo, lo + per


def split_batch(arr, mesh: Optional[DeviceMesh], device) -> Tuple[torch.Tensor, int]:
    """This rank's rows of ``arr`` (numpy or tensor) on ``device``, the
    batch padded to a dp multiple by repeating its last row, and the real
    row count (stable_ts_tpu/loaders.py:80-97). Without a mesh: all of
    ``arr`` on ``device``. Host rows go to the card through pinned
    memory."""
    t = (torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray)
         else torch.as_tensor(arr))
    n = t.shape[0]
    padded, lo, hi = batch_rows(n, mesh)
    if (lo, hi) != (0, n):
        t = t[torch.arange(lo, hi).clamp_(max=n - 1).to(t.device)]
    if t.device.type == 'cpu' and torch.device(device).type == 'cuda':
        # queued without waiting: an upload from pageable memory would wait
        # for the work already queued on the card
        return t.pin_memory().to(device, non_blocking=True), n
    return t.to(device), n


def gather_batch(t: torch.Tensor, mesh: Optional[DeviceMesh],
                 dim: int = 0) -> torch.Tensor:
    """All-gather ``t``, this rank's rows of a batch along ``dim``, over dp
    into the padded global batch (every rank gets it). The identity
    without a mesh or with dp = 1."""
    if mesh is None or mesh['dp'].size() == 1:
        return t
    x = t.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh['dp'].size())]
    dist.all_gather(parts, x, group=mesh.get_group('dp'))
    return torch.cat(parts, dim=dim)


def all_ranks_agree(flag: bool, device, mesh: Optional[DeviceMesh]) -> bool:
    """True on every rank when ``flag`` is true on any rank of the world
    (an all-reduce MAX of one int). Ranks that must take the same branch
    (the driver's out-of-memory retry) decide through it. Without a mesh:
    ``flag``."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
