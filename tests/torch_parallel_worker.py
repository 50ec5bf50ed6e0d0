"""One rank of a gloo world on the CPU that runs the port's sharded checks
for tests/test_torch_parallel.py and tests/test_torch_parallel_train.py.

    python tests/torch_parallel_worker.py JOB RANK

JOB is a pickle the test writes: {'world', 'port', 'tp', 'checks',
'inputs', 'out'}. ``inputs`` holds the JAX models' weights as numpy
pytrees (the port loads them through ``convert.from_jax_params``), the
tokenizer ranks, the alignment heads and the audio. Every check runs the
port on the (dp, tp) mesh of the world and, where the test compares the
two, unsharded in the same process. The rank writes {check: result} to
``out/rank<RANK>.pkl``, with the modules it loaded whose names start with
jax or stable_ts_tpu. (No such module may load: this file imports torch
and stable_ts_tpu_torch only.)
"""
import os
import pickle
import sys
import time
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

SR = 16000


def _model(inp, key='params', heads=True):
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
    from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions
    dims = ModelDimensions(**inp['dims'])
    return WhisperTorch(dims, from_jax_params(inp[key], dims, device='cpu'),
                        device='cpu', name='test-tiny', ranks=inp['ranks'],
                        alignment_heads=inp['heads'] if heads else None)


def _words(result):
    return dict(text=result.text,
                starts=[w.start for s in result.segments for w in s.words],
                ends=[w.end for s in result.segments for w in s.words])


def _both(inp, mesh, run, **model_kw):
    """run(model) on the sharded model and on an unsharded one."""
    return dict(sharded=run(_model(inp, **model_kw).shard(mesh)),
                plain=run(_model(inp, **model_kw)))


def check_placement(inp, mesh):
    from stable_ts_tpu_torch.parallel import data_sharding, param_shardings
    from stable_ts_tpu_torch.parallel.mesh import param_specs
    m = _model(inp).shard(mesh)
    enc = m.params.encoder
    specs = param_specs(m.dims, mesh['tp'].size())
    names = ('encoder.blocks.0.attn.q.weight', 'decoder.blocks.1.cross_attn.v.bias',
             'decoder.blocks.0.mlp.fc2.weight', 'encoder.blocks.1.attn.out.bias',
             'decoder.token_emb', 'encoder.conv1.weight', 'decoder.ln.weight')
    return dict(specs={n: specs[n] for n in names}, n_specs=len(specs),
                n_params=len(list(_model(inp).params.named_parameters())),
                shardings={n: str(p) for n, p in param_shardings(mesh, m.dims).items()
                           if n in names[:3]},
                data=str(data_sharding(mesh, 3)),
                dp=mesh['dp'].size(), tp=mesh['tp'].size(),
                q_rows=enc.blocks[0].attn.q.inner.weight.shape[0],
                out_cols=enc.blocks[0].attn.out.inner.weight.shape[1],
                out_bias=enc.blocks[0].attn.out.bias.shape[0],
                width=m.dims.n_audio_state, n_head=enc.n_head,
                n_head_total=enc.n_head_total)


def check_shard_batch(inp, mesh):
    m = _model(inp).shard(mesh)
    dp = mesh['dp'].size()
    arr = np.arange((dp + 1) * 4, dtype=np.float32).reshape(dp + 1, 4)
    local, n = m.shard_batch(arr)
    return dict(n=n, local=local.numpy(), gathered=m.gather_batch(local).numpy())


def check_greedy(inp, mesh):
    audio = inp['audio'][:SR * 35]
    return _both(inp, mesh, lambda m: _words(m.transcribe_batched(
        audio, temperature=0, verbose=None)))


def check_beam2(inp, mesh):
    audio = inp['audio'][:SR * 20]
    return _both(inp, mesh, lambda m: _words(m.transcribe_batched(
        audio, temperature=0, beam_size=2, verbose=None)))


def check_no_heads(inp, mesh):
    audio = inp['audio'][:SR * 35]
    return _both(inp, mesh, lambda m: _words(m.transcribe_batched(
        audio, temperature=0, verbose=None)), heads=False)


def check_dq(inp, mesh):
    """dq at tp: the transcript, and the int8 codes and scales of the
    cross K/V of every layer and of the self cache's first layer (rows
    projected from the same features and the same embeddings in both
    models), this rank's heads gathered over tp."""
    from stable_ts_tpu_torch.models.whisper.model import (decoder_prefill,
                                                          precompute_cross_kv_t)
    audio = inp['audio'][:SR * 20]
    out = _both(inp, mesh, lambda m: _words(m.transcribe_batched(
        audio, temperature=0, verbose=None)), key='params_dq')
    sharded, plain = _model(inp, 'params_dq').shard(mesh), _model(inp, 'params_dq')
    mel = torch.from_numpy(inp['mel'])
    tokens = torch.tensor([[1, 2, 3, 4, 5]] * mel.shape[0])
    group = mesh.get_group('tp')

    with torch.inference_mode():
        xa = plain.embed_audio(mel)

    def codes(m):
        with torch.inference_mode():
            kv = precompute_cross_kv_t(m.params.decoder, xa, quantize=8)
            _, cache = decoder_prefill(m.params.decoder, tokens, xa, 8)
        return kv['kv'], kv['sc'], cache['k'][0], cache['ks'][0]

    def gathered(t):
        parts = [torch.empty_like(t) for _ in range(mesh['tp'].size())]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=-1).numpy()

    kv_s, sc_s, k_s, ks_s = codes(sharded)
    kv_p, sc_p, k_p, ks_p = codes(plain)
    out.update(cross_codes_equal=bool(np.array_equal(gathered(kv_s), kv_p.numpy())),
               cross_scales_equal=bool(torch.equal(sc_s, sc_p)),
               self_codes_equal=bool(np.array_equal(gathered(k_s), k_p.numpy())),
               self_scales_equal=bool(torch.equal(ks_s, ks_p)),
               row_scale_shape=tuple(sharded.params.decoder.blocks[0].mlp.fc2
                                     .inner.scale.shape))
    return out


def check_align(inp, mesh):
    audio = inp['audio'][:SR * 12]
    text = ' hello world this is a mesh test'
    return _both(inp, mesh, lambda m: _words(m.align(
        audio, text, language='en', verbose=None)))


def check_align_words(inp, mesh):
    audio = inp['audio'][:SR * 24]
    segs = [dict(start=4.0 * i, end=4.0 * (i + 1), text=f' word{i} and more{i}')
            for i in range(6)]
    return _both(inp, mesh, lambda m: _words(m.align_words(
        audio, [dict(s) for s in segs], language='en', verbose=None,
        parallel=True)))


def check_refine(inp, mesh):
    audio = inp['audio'][:SR * 12]
    text = ' hello world refine me'

    def run(m):
        base = m.align(audio, text, language='en', verbose=None)
        return _words(m.refine(audio, base, inplace=False, parallel=True,
                               verbose=None))
    return _both(inp, mesh, run)


def check_locate(inp, mesh):
    """locate, modes 0 and 1 (the estimate's capture and the confirmation
    decode over float caches), of the first word the greedy transcript
    emits in 24 s, with probability_threshold=0.0."""
    audio = inp['audio'][:SR * 24]

    def run(m):
        word = m.transcribe_batched(audio, temperature=0, verbose=None).text.split()[0]
        out = []
        for mode in (0, 1):
            found = m.locate(audio, word, language='en', mode=mode, count=2,
                             probability_threshold=0.0, verbose=None)
            out.append([(round(f.start, 3), round(f.end, 3)) if hasattr(f, 'start')
                        else (round(f['end'], 3), f['text']) for f in found])
        return out
    return _both(inp, mesh, run)


def check_best_of(inp, mesh):
    """transcribe_batched on the ladder (0.0, 0.4) with best_of=2, every
    window failing temperature 0 (compression_ratio_threshold=-1): the
    sampled retries split over dp."""
    audio = inp['audio'][:SR * 35]
    return _both(inp, mesh, lambda m: _words(m.transcribe_batched(
        audio, temperature=(0.0, 0.4), best_of=2, compression_ratio_threshold=-1.0,
        verbose=None)))


def check_sampling(inp, mesh):
    """temperature 0.8, best_of 2 over four windows: the draws of every
    row, sharded and not."""
    from stable_ts_tpu_torch.models.whisper.decoding import DecodingOptions
    mel = torch.from_numpy(inp['mel'])
    opts = DecodingOptions(language='en', temperature=0.8, best_of=2,
                           sample_len=24)
    return _both(inp, mesh, lambda m: [r.tokens for r in m.decode(
        mel, opts, generator=torch.Generator().manual_seed(5))])


def check_oom(inp, mesh):
    """Rank 0's first decode (the port's ``decode_launch`` under the model
    wrapper) raises an out-of-memory error: every rank must halve the
    batch and finish with the unsharded transcript."""
    from stable_ts_tpu_torch import loaders
    audio = inp['audio'][:SR * 35]
    plain = _words(_model(inp).transcribe_batched(audio, batch_size=4,
                                                  temperature=0, verbose=None))
    real = loaders._decode_launch
    raised = []

    def flaky(*args, **kwargs):
        if dist.get_rank() == 0 and not raised:
            raised.append(True)
            raise torch.OutOfMemoryError('injected')
        return real(*args, **kwargs)

    loaders._decode_launch = flaky
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            sharded = _words(_model(inp).shard(mesh).transcribe_batched(
                audio, batch_size=4, temperature=0, verbose=None))
    finally:
        loaders._decode_launch = real
    return dict(plain=plain, sharded=sharded,
                warnings=[str(w.message) for w in caught
                          if 'out of memory' in str(w.message)])


def check_oom_tp(inp, mesh):
    """On the dp 2 x tp 2 mesh both ranks of dp row 0's tp group raise an
    out-of-memory error in their first decode step, just after its first
    tp all-reduce; dp row 1 decodes on to the agreement. Every rank must
    halve the batch and finish with the unsharded transcript. (One rank
    of a tp group raising alone would leave its peer in that group's next
    all-reduce: the limitation ROADMAP.md section 3 states.)"""
    from stable_ts_tpu_torch.models.whisper import decoding
    audio = inp['audio'][:SR * 35]
    plain = _words(_model(inp).transcribe_batched(audio, batch_size=4,
                                                  temperature=0, verbose=None))
    real_step, real_reduce = decoding.decoder_step, dist.all_reduce
    state = dict(in_step=False, raised=False, reduces=0)

    def step(*args, **kwargs):
        state['in_step'] = True
        try:
            return real_step(*args, **kwargs)
        finally:
            state['in_step'] = False

    def all_reduce(*args, **kwargs):
        out = real_reduce(*args, **kwargs)
        if state['in_step'] and not state['raised']:
            state['reduces'] += 1
            if mesh.get_local_rank('dp') == 0:
                state['raised'] = True
                raise torch.OutOfMemoryError('injected')
        return out

    decoding.decoder_step, dist.all_reduce = step, all_reduce
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            sharded = _words(_model(inp).shard(mesh).transcribe_batched(
                audio, batch_size=4, temperature=0, verbose=None))
    finally:
        decoding.decoder_step, dist.all_reduce = real_step, real_reduce
    return dict(plain=plain, sharded=sharded, raised=state['raised'],
                warnings=[str(w.message) for w in caught
                          if 'out of memory' in str(w.message)])


def check_train(inp, mesh):
    """Two dp x tp train steps and two unsharded ones from the same
    weights: the losses, and (rank 0) the whole updated weights."""
    from stable_ts_tpu_torch.models.whisper.convert import from_jax_params
    from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions
    from stable_ts_tpu_torch.models.whisper.train import make_train_step
    from stable_ts_tpu_torch.parallel import shard_params
    from stable_ts_tpu_torch.parallel.mesh import full_state_dict
    dims = ModelDimensions(**inp['train_dims'])
    init, step = make_train_step(dims)
    out = {}
    for kind in ('sharded', 'plain'):
        model = from_jax_params(inp['train_params'], dims, device='cpu')
        if kind == 'sharded':
            shard_params(model, mesh, dims)
        opt = init(model)
        losses = [float(step(model, opt, inp['train_mel'], inp['train_tokens']))
                  for _ in range(inp['train_steps'])]
        state = full_state_dict(model, dims)
        out[kind] = dict(losses=losses, params=(
            {k: v.numpy() for k, v in state.items()} if dist.get_rank() == 0
            else None))
    return out


CHECKS = {name[len('check_'):]: fn for name, fn in globals().items()
          if name.startswith('check_')}


def main():
    with open(sys.argv[1], 'rb') as f:
        job = pickle.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    from stable_ts_tpu_torch.parallel import build_mesh, distributed_init
    distributed_init(f"127.0.0.1:{job['port']}", job['world'], rank,
                     backend='gloo')
    mesh = build_mesh(tp=job['tp'])
    results, seconds = {}, {}
    for name in job['checks']:
        t0 = time.perf_counter()
        try:
            results[name] = CHECKS[name](job['inputs'], mesh)
            seconds[name] = time.perf_counter() - t0
        except Exception:
            # a failed check leaves the world out of step: stop here
            results[name] = {'error': traceback.format_exc()}
            break
    results['seconds'] = seconds
    results['modules'] = sorted(
        m for m in sys.modules
        if m.split('.')[0] in ('jax', 'jaxlib', 'stable_ts_tpu'))
    with open(os.path.join(job['out'], f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
