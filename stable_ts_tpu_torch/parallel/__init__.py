"""Multi-GPU scaling of the port: the (dp, tp) mesh, the sharding rules, the
tensor-parallel linears and the batch split (counterpart of
stable_ts_tpu/parallel/).

The execution model is PyTorch's multi-controller SPMD, where the JAX
package is single-controller:

- One process per GPU (started by ``torchrun`` or
  ``torch.multiprocessing``), all in one ``torch.distributed`` world
  (:func:`distributed_init`). Every rank runs the same host code on the same
  inputs, so every rank issues the same collectives in the same order.
- :func:`build_mesh` lays the world out as a
  ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names=('dp', 'tp')``, rank ``i * tp + j`` at (dp i, tp j), as
  JAX reshapes its devices.
- :func:`shard_params` keeps only this rank's weight shard: Megatron column
  splits of q, k, v and fc1 and row splits of out and fc2 over ``tp``
  (:class:`ColumnParallelLinear`, :class:`RowParallelLinear`), whole heads
  per rank. Each rank's kernels (flash attention, the decode-attention
  entries, ``woq_matmul``) run on its local heads, where the JAX package
  turns its Pallas kernels off on a mesh (they have no partitioning rule).
  The collectives are explicit: a tp all-reduce after every row linear, its
  bias added once after it; an all-reduce MAX of the per-row amax wherever a
  row over ``d`` is quantized (the int8 self cache, the int8 / int4 cross
  K/V, ``dyn``'s activations), so the codes equal the unsharded ones; an
  all-reduce of the head capture, each slot owned by one rank.
- The batch seam: ``WhisperTorch.shard_batch`` pads a batch's rows to a
  ``dp`` multiple by repeating the last row and keeps this rank's rows;
  ``WhisperTorch.gather_batch`` all-gathers a device result over ``dp``
  into the padded global batch. Every host download follows a gather, so
  every rank's host code sees the global arrays that the JAX package's
  callers see. ``embed_audio`` and ``decode_launch`` / ``decode_collect``
  split and gather inside (global rows in, global rows out); the
  word-timing pass, the align family's passes and the refine rounds call
  ``shard_batch`` where the JAX package does and gather their token
  probabilities and DTW costs before they download them.

Pipeline parallelism is not used (every Whisper size fits one GPU) and
there is no MoE.
"""
from .mesh import (build_mesh, data_sharding, distributed_init, param_shardings,
                   shard_params)

__all__ = ['build_mesh', 'param_shardings', 'data_sharding', 'shard_params',
           'distributed_init']
