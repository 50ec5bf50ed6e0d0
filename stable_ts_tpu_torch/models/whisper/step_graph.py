"""A CUDA graph of the greedy decoder step.

The greedy loop's step (:func:`~.model.decoder_step` with
``return_hidden``) queues about 30 kernels a layer from Python: on
large-v3, about 1,000 launches a token, which the host takes longer to
queue than the card takes to run. A :class:`StepGraph` captures the step of
one shape into one ``torch.cuda.CUDAGraph`` and replays it for every later
token: the host then queues four small copies and fills (the token, the
position, the two cross K/V addresses) and one replay. The kernels, their
order and their dtypes are the eager step's, so the outputs are the same
bits.

What changes from step to step or group to group, the captured step reads
on the device: its position from a 0-d int64 tensor (``_embed``,
``_write_rows`` and the self-decode kernel each take one), its token from a
static input, and the addresses of the group's cross K/V and scales from a
(2,) int64 tensor (``cross_attn_decode_indirect``), so the cross K/V,
the largest buffer of a decode (3.9 GB at 32 rows of large-v3), is made
for each group as in an eager decode and its memory serves the encoder and
the word-timing pass between decodes. The self cache and the fused q/k/v
weights are kept: ``decoder_prefill`` fills the cache in place (``out``)
for each group, and the hidden state goes to a static output.

A decoder keeps one runner (:func:`kept`), for one key: the row count, the
cross K/V's layout and the decoder's weights (where each tensor lives and
how often it was written, and the quantized linears' recipe). Its cache is
as long as the longest decode it has met: a shorter decode replays the same
graph (the self kernel's launch is sized for the cache, its keys are the
position's). A decode of another key, or a longer one, releases the runner
before it makes its own cache, so the halving retry after an out-of-memory
error frees the larger cache first.

Only what the code can observe engages a graph (:func:`graphable`): a CUDA
device, the greedy step (``return_hidden``), one query row for each cross
K/V row, no beam ancestry and no tp group. Every other step (sampling,
beam, best_of, ``locate``, the tp-sharded mesh, the CPU) runs eagerly.

A new runner's first ``WARM_STEPS`` calls are eager decode steps; the next
one captures and replays (``torch.cuda.graph`` synchronizes the device
before it captures). The kernel launches of ``_build.launches`` are counted
in Python: a replay adds those its capture counted. Counters
(``profiling``): ``decode.graph_captures``, ``decode.graph_replays`` and
``decode.eager_steps`` (the steps queued eagerly, here and in
``decoder_step``).
"""
import itertools
from typing import Optional

import torch

from ... import _build, profiling
from .model import TextDecoder, _decoder_step, fuse_self_qkv
from .quantization import _woq_mode

WARM_STEPS = 2     # eager steps of a new runner before its capture


def graphable(decoder: TextDecoder, device, *, return_hidden: bool,
              q_per_kv: int = 1, anc=None) -> bool:
    """Whether a decoder step with these arguments replays a graph: only
    the greedy step of an unsharded decoder on a CUDA device."""
    return (torch.device(device).type == 'cuda' and return_hidden
            and q_per_kv == 1 and anc is None and decoder.tp_group is None)


class StepGraph:
    """The greedy step of one key over its cache and the decoder's fused
    q/k/v weights: eager for ``WARM_STEPS`` calls, then captured once and
    replayed. A call returns the (rows, d) hidden state; after a replay
    that is the graph's output buffer, which the next call overwrites."""

    def __init__(self, decoder: TextDecoder, key: tuple, cache: dict):
        dev = cache['k'].device
        self.decoder, self.key, self.cache = decoder, key, cache
        self.fused_qkv = fuse_self_qkv(decoder)
        self.tokens = torch.zeros((cache['k'].shape[1], 1), dtype=torch.long,
                                  device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.bases = torch.zeros(2, dtype=torch.long, device=dev)
        self.graph = self.hidden = None
        self.launches = None   # the wrappers' launches in one step
        self.warm = 0

    def __call__(self, tokens: torch.Tensor, pos: int,
                 cross_kv: dict) -> torch.Tensor:
        if self.graph is None and self.warm < WARM_STEPS:
            self.warm += 1
            profiling.count('decode.eager_steps')
            return _decoder_step(self.decoder, tokens, pos, cross_kv, self.cache,
                                 self.fused_qkv, return_hidden=True)
        for i, name in enumerate(('kv', 'sc')):
            self.bases[i].fill_(cross_kv[name].data_ptr())
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        if self.graph is None:
            self._capture(cross_kv)
        self.graph.replay()
        _build.launches.update(self.launches)
        profiling.count('decode.graph_replays')
        return self.hidden

    def _capture(self, cross_kv: dict):
        graph = torch.cuda.CUDAGraph()
        before = _build.launches.copy()
        with torch.cuda.graph(graph):
            self.hidden = _decoder_step(
                self.decoder, self.tokens, self.pos, {**cross_kv, 'bases': self.bases},
                self.cache, self.fused_qkv, return_hidden=True)
        # the capture queued nothing: its launches are counted at each replay
        self.launches = _build.launches - before
        _build.launches.clear()
        _build.launches.update(before)
        self.graph = graph
        profiling.count('decode.graph_captures')

    def __deepcopy__(self, memo):
        return None    # a copied model captures its own


def _weights_key(decoder: TextDecoder) -> tuple:
    """Where each of the decoder's tensors lives and how often it was
    written, and the quantized linears' recipe: what a capture bakes in."""
    return (_woq_mode(), tuple(
        (t.data_ptr(), 0 if t.is_inference() else t._version)
        for t in itertools.chain(decoder.parameters(), decoder.buffers())))


def kept(decoder: TextDecoder, rows: int, cross: tuple,
         cache_len: int) -> tuple:
    """(the decoder's runner for a decode of ``rows`` rows, cross K/V layout
    ``cross`` and a cache of ``cache_len`` positions, or None; the key a
    new runner takes). A runner of another key, or with a shorter cache, is
    released here, before the caller makes its cache."""
    key = (rows, cross, _weights_key(decoder))
    runner: Optional[StepGraph] = decoder._step_graph
    if runner is not None and (runner.key != key
                               or runner.cache['k'].shape[2] < cache_len):
        decoder._step_graph = runner = None
    return runner, key
