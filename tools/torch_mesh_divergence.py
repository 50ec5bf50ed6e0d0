#!/usr/bin/env python3
"""Where a sharded f32 run of the PyTorch port first leaves the unsharded
one, and by what margin.

Large-v3 with random f32 weights (seed 0) on ``synth_speech_like(155.0)``,
the model and audio of ``chip_smoke.py``'s two-rank phase, at full size:
``transcribe_batched`` greedy 60 s (one group of 2 windows, the full
sample length), ``align_words`` of 60 s (six 10-s segments, ``parallel``),
a refine of its result and a refine of the unsharded run's result
(``prob_threshold=0.0``). They run unsharded in this process, then in two
spawned ranks over gloo (both on cuda:0, as NCCL refuses two ranks on one
GPU) at dp 1 x tp 2 and at dp 2 x tp 1. With ``--cpu`` the greedy request
also runs on the CPU (the kernels' plain twins), unsharded and in a
two-rank gloo world at tp 2, on the same weights.

For each run against its reference (the unsharded run on the same device;
the CPU's also against the card's) the script reports whether text and
words are equal and the largest word-start difference, and:

- greedy: every step's hidden state, grammar flags and logit aggregates
  are recorded; for each window whose tokens part, the first step where
  they do, the filtered logits of both tokens in both runs (recomputed in
  f64 from the recorded hidden states), each run's top-2 gap there, the
  largest logit difference of the runs at that step, the largest
  hidden-state difference before it, and the smallest and median top-2
  gap of the reference run before it;
- align_words: for each segment of the one batched DTW, the largest
  difference of the captured head scores and of the DTW inputs, the jump
  frames' largest difference and, where they part, each path's sum on
  the other run's input over the optimum there (f64) and how much the
  input difference moved each path's sum.

    python3 tools/torch_mesh_divergence.py --cpu --out chiprun_out/mesh_divergence.json
    python3 tools/torch_mesh_divergence.py --model tiny --devices cpu   # a dry run, no GPU
"""
import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (SR, align_words_grid, synthetic_ranks, ...)

SR = cs.SR


def log(msg: str) -> None:
    print(msg, flush=True)


class Recorder:
    """Wraps the decoder's logit-aggregate calls: for each greedy decode,
    the filtered logits of step 0 (the prefill's) and every later step's
    hidden state, grammar flags and aggregates, on the host."""

    def __init__(self):
        from stable_ts_tpu_torch.models.whisper import decoding
        self.decodes = []
        self._mod = decoding
        self._orig = (decoding.logit_aggregates, decoding.fused_logit_aggregates)
        la, fla = self._orig

        def logit_aggregates(filtered, ts_begin):
            agg = la(filtered, ts_begin)
            self.decodes.append(dict(step0=filtered.float().cpu(), aggs=[agg.cpu()],
                                     xs=[None], flags=[None], ts_begin=ts_begin))
            return agg

        def fused_logit_aggregates(x, emb, suppress, ts_silence, flags, ts_begin, eot,
                                   with_grammar=True):
            agg = fla(x, emb, suppress, ts_silence, flags, ts_begin, eot, with_grammar)
            d = self.decodes[-1]
            d['aggs'].append(agg.cpu())
            d['xs'].append(x.float().cpu())
            d['flags'].append(flags.cpu())
            d.update(suppress=suppress.cpu(), eot=eot, with_grammar=with_grammar,
                     ts_silence=None if ts_silence is None else ts_silence.cpu())
            return agg

        decoding.logit_aggregates = logit_aggregates
        decoding.fused_logit_aggregates = fused_logit_aggregates

    def close(self):
        self._mod.logit_aggregates, self._mod.fused_logit_aggregates = self._orig


class DTWRecorder:
    """Wraps the align family's batched DTW: each call's captured head
    scores and DTW input (this rank's rows of the negated head weights),
    the gathered costs, the walks' corners and jump frames, on the host.
    The first two are the weights and cost calls of
    ``timing.known_heads_pass``, the walks ``align_words``' traceback."""

    def __init__(self):
        from stable_ts_tpu_torch import alignment
        from stable_ts_tpu_torch.models.whisper import timing
        self.calls = []
        self._orig = (timing.legacy_weights_batched, timing.dtw_cost,
                      alignment.dtw_jumps_batched)
        weights_fn, cost_fn, jumps_fn = self._orig

        def legacy_weights_batched(qks_sel, *args):
            self.calls.append(dict(qk=qks_sel.float().cpu()))
            return weights_fn(qks_sel, *args)

        def dtw_cost(neg):
            self.calls[-1]['x'] = neg.float().cpu()
            return cost_fn(neg)

        def dtw_jumps_batched(cost, n_rows, m_cols):
            jumps = jumps_fn(cost, n_rows, m_cols)
            self.calls[-1].update(cost=np.asarray(cost, np.float32), n=list(n_rows),
                                  m=list(m_cols), jumps=jumps)
            return jumps

        timing.legacy_weights_batched, timing.dtw_cost = legacy_weights_batched, dtw_cost
        alignment.dtw_jumps_batched = dtw_jumps_batched

    def close(self):
        from stable_ts_tpu_torch import alignment
        from stable_ts_tpu_torch.models.whisper import timing
        weights_fn, cost_fn, jumps_fn = self._orig
        timing.legacy_weights_batched, timing.dtw_cost = weights_fn, cost_fn
        alignment.dtw_jumps_batched = jumps_fn


def build(cfg: dict, device: str, mesh=None):
    """The f32 model of ``cfg`` on ``device``, drawn on the card when there
    is one (the CPU runs then hold the card's weights), sharded on
    ``mesh`` when given."""
    import torch
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.model import init_params
    dims = cfg['dims']
    draw = 'cuda' if torch.cuda.is_available() else 'cpu'
    params = init_params(dims, seed=0, dtype=torch.float32, device=draw).to(device)
    model = WhisperTorch(dims, params, device=device, name=cfg['name'],
                         ranks=cfg['ranks'], alignment_heads=cfg['heads'])
    return model if mesh is None else model.shard(mesh)


def run_requests(cfg: dict, model, names) -> dict:
    """{name: (summary, wall, records)} of the requests ``names`` on
    ``model``: 'greedy' (its decodes' records), 'align_words' (its DTW
    calls' records), 'refine' (of this run's ``align_words`` result) and
    'refine_ref' (of ``cfg['ref_aligned']``, the unsharded run's)."""
    import torch
    from stable_ts_tpu_torch.result.whisper_result import WhisperResult
    audio = cfg['audio']
    clip = audio[:60 * SR]
    out, aligned = {}, []
    fns = {
        'greedy': lambda: model.transcribe_batched(clip, batch_size=2, language='en',
                                                   temperature=0, verbose=None),
        'align_words': lambda: aligned.append(model.align_words(
            clip, [dict(s) for s in cs.align_words_grid(60.0)], language='en',
            parallel=True, verbose=None)) or aligned[0],
        'refine': lambda: model.refine(clip, aligned[0], inplace=False,
                                       prob_threshold=0.0, verbose=None),
        'refine_ref': lambda: model.refine(clip, WhisperResult(cfg['ref_aligned']),
                                           inplace=False, prob_threshold=0.0,
                                           verbose=None),
    }
    recorders = {'greedy': Recorder, 'align_words': DTWRecorder}
    for name in names:
        rec = recorders[name]() if name in recorders else None
        sync = torch.cuda.synchronize if model.device.type == 'cuda' else (lambda: None)
        sync()
        t0 = time.perf_counter()
        try:
            result = fns[name]()
            sync()
        finally:
            if rec is not None:
                rec.close()
        records = (None if rec is None
                   else rec.decodes if isinstance(rec, Recorder) else rec.calls)
        out[name] = (cs._summary(result), time.perf_counter() - t0, records)
    if aligned:
        out['_aligned'] = aligned[0].to_dict()
    return out


def config(model_name: str) -> dict:
    from stable_ts_tpu_torch.audio.synth import synth_speech_like
    from stable_ts_tpu_torch.models.whisper import alignment_heads
    from stable_ts_tpu_torch.models.whisper.dims import (OPENAI_MODEL_DIMS,
                                                         ModelDimensions, tiny_test_dims)
    from stable_ts_tpu_torch.models.whisper.tokenizer import synthetic_byte_ranks
    if model_name == 'tiny':
        dims, ranks, heads = tiny_test_dims(), synthetic_byte_ranks(), cs.HEADS_TINY
    else:
        dims = ModelDimensions(**OPENAI_MODEL_DIMS[model_name])
        ranks = cs.synthetic_ranks()
        heads = alignment_heads.get_alignment_heads(model_name, dims.n_text_layer,
                                                    dims.n_text_head)
    return dict(name=model_name, dims=dims, ranks=ranks, heads=heads,
                audio=synth_speech_like(155.0))


def rank_main(rank: int, port: int, out_dir: str, model_name: str, device: str,
              plan, ref_aligned) -> None:
    """One of two spawned ranks: for each (tp, request names) of ``plan``,
    the requests on the model sharded on a (2 / tp, tp) mesh of
    ``device``; writes ``out_dir/rank<rank>.pkl``."""
    import torch
    from stable_ts_tpu_torch.parallel import build_mesh, distributed_init
    if device == 'cuda':
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from stable_ts_tpu_torch import _build
        _build.lib()
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    distributed_init(f'127.0.0.1:{port}', 2, rank, backend='gloo')
    cfg = config(model_name)
    cfg['ref_aligned'] = ref_aligned
    out = {}
    for tp, names in plan:
        mesh = build_mesh(tp=tp, devices=device)
        key = f'dp {mesh["dp"].size()} x tp {mesh["tp"].size()}'
        model = build(cfg, device, mesh)
        out[key] = run_requests(cfg, model, names)
        del model
    with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def spawn(model_name: str, device: str, plan, ref_aligned=None) -> list:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(cs._free_port(), tmp, model_name, device, plan,
                                      ref_aligned),
                 nprocs=2, join=True)
        log(f'[spawn] two {device} ranks, {plan}: {time.perf_counter() - t0:.1f} s')
        got = []
        for rank in range(2):
            with open(os.path.join(tmp, f'rank{rank}.pkl'), 'rb') as f:
                got.append(pickle.load(f))
    return got


# -- the analysis ---------------------------------------------------------------------------

def window_views(decodes_by_rank, dp: int) -> list:
    """[(decode record, row)] for each global window of the one greedy
    decode: rank 0's rows without a dp split, rank r's one row at dp 2."""
    if dp == 1:
        dec = decodes_by_rank[0][0]
        return [(dec, r) for r in range(dec['aggs'][0].shape[0])]
    return [(decodes_by_rank[r][0], 0) for r in range(dp)]


def tokens_of(view) -> list:
    from stable_ts_tpu_torch.ops.logit_epilogue import select_from_aggregates
    dec, row = view
    grammar = dec.get('with_grammar', True)
    return [int(select_from_aggregates(a[row:row + 1], grammar)[0][0]) for a in dec['aggs']]


def filtered(view, i: int, emb64):
    """The step's filtered logits in f64 (step 0: the recorded ones)."""
    import torch
    from stable_ts_tpu_torch.ops.logit_epilogue import grammar_filter
    dec, row = view
    if i == 0:
        return dec['step0'][row].to(emb64.device, torch.float64)
    x = dec['xs'][i][row:row + 1].to(emb64.device, torch.float64)
    ts = dec['ts_silence']
    ts = None if ts is None else ts[row:row + 1].to(emb64.device, torch.float64)
    return grammar_filter(x @ emb64.t(), dec['suppress'].to(emb64.device, torch.float64),
                          ts, dec['flags'][i][row:row + 1].to(emb64.device),
                          dec['ts_begin'], dec['eot'], dec['with_grammar'])[0]


def top2_gap(f) -> float:
    v = f.topk(2).values
    return float(v[0] - v[1])


def first_divergence(ref_view, got_view, emb64) -> dict:
    import torch
    a_toks, b_toks = tokens_of(ref_view), tokens_of(got_view)
    eot = ref_view[0].get('eot')
    n = min(len(a_toks), len(b_toks))
    k = next((i for i in range(n) if a_toks[i] != b_toks[i]), None)
    out = dict(steps=[len(a_toks), len(b_toks)])
    if k is None:
        out['equal'] = a_toks[:n] == b_toks[:n]
        return out
    fr, fg = filtered(ref_view, k, emb64), filtered(got_view, k, emb64)
    a, b = a_toks[k], b_toks[k]
    live = (fr > -1e8) & (fg > -1e8)     # the bans add -1e9
    gaps, dx = [], 0.0
    for j in range(1, k):
        gaps.append(top2_gap(filtered(ref_view, j, emb64)))
        xr, xg = ref_view[0]['xs'][j][ref_view[1]], got_view[0]['xs'][j][got_view[1]]
        dx = max(dx, float((xr - xg).abs().max()))
    gaps.sort()
    out.update(
        step=k, ref_token=a, got_token=b, eot=eot,
        ref_logits={'ref_token': float(fr[a]), 'got_token': float(fr[b])},
        got_logits={'ref_token': float(fg[a]), 'got_token': float(fg[b])},
        ref_margin=float(fr[a] - fr[b]), got_margin=float(fg[b] - fg[a]),
        ref_top2_gap=top2_gap(fr), got_top2_gap=top2_gap(fg),
        max_logit_diff=float((fr - fg)[live].abs().max()),
        logit_scale=float(fr[live].abs().max()),
        max_hidden_diff_before=dx,
        hidden_scale=float(ref_view[0]['xs'][max(k, 1)][ref_view[1]].abs().max())
        if k >= 1 else None,
        ref_aggs=ref_view[0]['aggs'][k][ref_view[1]].tolist(),
        got_aggs=got_view[0]['aggs'][k][got_view[1]].tolist(),
        ref_gap_min_before=gaps[0] if gaps else None,
        ref_gap_median_before=gaps[len(gaps) // 2] if gaps else None)
    return out


def dtw_table(x: np.ndarray) -> np.ndarray:
    """The DTW cost table of ``x`` (n, m) in f64 (ops/dtw.py's recurrence)."""
    n, m = x.shape
    c = np.full((n + 1, m + 1), np.inf)
    c[0, 0] = 0.0
    for i in range(1, n + 1):
        above = np.minimum(c[i - 1, :-1], c[i - 1, 1:])
        row, xi = c[i], x[i - 1]
        for j in range(1, m + 1):
            row[j] = xi[j - 1] + min(above[j - 1], row[j - 1])
    return c


def walk(cost: np.ndarray, n: int, m: int) -> list:
    """The cells of the traceback from (n, m) over an f32 cost table, with
    ops/dtw.py's ``dtw_jumps`` tie order."""
    cells, i, j = [], n, m
    while i > 0 or j > 0:
        cells.append((i, j))
        im1, jm1 = max(i - 1, 0), max(j - 1, 0)
        c_diag, c_up, c_left = cost[im1, jm1], cost[im1, j], cost[i, jm1]
        diag = c_diag < c_up and c_diag < c_left
        up = c_up < c_diag and c_up < c_left and not diag
        diag = diag and i > 0 and j > 0
        up = i > 0 if j == 0 else (up and i > 0)
        if diag or up:
            i -= 1
        if diag or not (diag or up):
            j -= 1
    return cells


def path_sum(cells, x: np.ndarray) -> float:
    return float(sum(x[i - 1, j - 1] for i, j in cells if i > 0 and j > 0))


def dtw_divergence(ref_calls, got_calls_by_rank, dp: int) -> list:
    """For each segment of the one batched DTW of ``align_words``: the
    largest difference of the runs' captured head scores and of their DTW
    inputs, its jump frames in both runs and, where they part, each path's sum on the other
    run's input over the optimum there (f64), how much the input
    difference moved each path's sum (the sharded path beats the other on
    its input only if the reference path's shift minus its own exceeds the
    first gap), and the most it can move a path's sum."""
    import torch
    ref = ref_calls[0]
    got = dict(got_calls_by_rank[0][0])
    if dp > 1:
        got['x'] = torch.cat([c[0]['x'] for c in got_calls_by_rank], dim=0)
        got['qk'] = torch.cat([c[0]['qk'] for c in got_calls_by_rank], dim=1)
    out = []
    for s, (n, m) in enumerate(zip(ref['n'], ref['m'])):
        n, m = int(n), min(int(m), ref['cost'].shape[-1] - 1)
        xr = ref['x'][s, :n, :m].double().numpy()
        xg = got['x'][s, :n, :m].double().numpy()
        dx = float(np.abs(xg - xr).max())
        qr, qg = ref['qk'][:, s, :, :m].double(), got['qk'][:, s, :, :m].double()
        e = dict(segment=s, n=n, m=m, max_input_diff=dx,
                 input_scale=float(np.abs(xr).max()),
                 max_score_diff=float((qg - qr).abs().max()),
                 score_scale=float(qr.abs().max()),
                 max_jump_diff_frames=int(np.abs(ref['jumps'][s, :n].astype(int)
                                                 - got['jumps'][s, :n].astype(int)).max()))
        if e['max_jump_diff_frames']:
            pr, pg = walk(ref['cost'][s], n, m), walk(got['cost'][s], n, m)
            vr, vg = dtw_table(xr)[n, m], dtw_table(xg)[n, m]
            e.update(optimum_ref=vr, optimum_got=vg, path_len=[len(pr), len(pg)],
                     got_path_over_optimum_on_ref=path_sum(pg, xr) - vr,
                     ref_path_over_optimum_on_got=path_sum(pr, xg) - vg,
                     ref_path_over_optimum_on_ref=path_sum(pr, xr) - vr,
                     got_path_over_optimum_on_got=path_sum(pg, xg) - vg,
                     ref_path_shift=path_sum(pr, xg) - path_sum(pr, xr),
                     got_path_shift=path_sum(pg, xg) - path_sum(pg, xr),
                     input_budget=(len(pr) + len(pg)) * dx)
        out.append(e)
    return out


def compare(label: str, ref: dict, got_by_rank: list, dp: int, emb64) -> dict:
    """Outputs of ``got`` (rank 0's, both ranks checked equal) against
    ``ref`` for each request ('refine_ref' against the reference's
    'refine'), the greedy decode's first divergence a window and the
    align_words DTW's paths a segment."""
    got = got_by_rank[0]
    names = [n for n in got if not n.startswith('_')]
    if len(got_by_rank) > 1:
        for name in names:
            if got_by_rank[1][name][0] != got[name][0]:
                raise AssertionError(f'{label} {name}: the ranks returned different results')
    report = {}
    for name in names:
        summary, wall, records = got[name]
        rs, ref_wall, ref_records = ref['refine' if name == 'refine_ref' else name]
        same = (summary['text'] == rs['text']
                and [w[0] for w in summary['words']] == [w[0] for w in rs['words']])
        diff = max((abs(x[1] - y[1]) for x, y in zip(summary['words'], rs['words'])),
                   default=0.0)
        entry = dict(text_and_words_equal=same, words=[len(summary['words']),
                                                      len(rs['words'])],
                     max_start_diff=diff, srt_equal=summary['srt'] == rs['srt'],
                     wall=wall, ref_wall=ref_wall)
        if name == 'greedy':
            refs = window_views([ref_records], 1)
            gots = window_views([g[name][2] for g in got_by_rank], dp)
            entry['windows'] = [first_divergence(r, g, emb64) for r, g in zip(refs, gots)]
        if name == 'align_words':
            entry['segments'] = dtw_divergence(
                ref_records, [g[name][2] for g in got_by_rank], dp)
        report[name] = entry
        log(f'[{label}] {name}: {json.dumps(entry)}')
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--model', default='large-v3')
    ap.add_argument('--devices', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--cpu', action='store_true',
                    help='also the greedy request on the CPU, unsharded and at tp 2')
    ap.add_argument('--requests', default='greedy,align_words,refine,refine_ref',
                    help='of greedy, align_words, refine, refine_ref (refine the '
                         "unsharded run's align_words result: it needs align_words)")
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    import torch
    device = args.devices
    if device == 'cuda':
        if not torch.cuda.is_available():
            print('no CUDA device', file=sys.stderr)
            return 2
        import subprocess
        log(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from stable_ts_tpu_torch import _build
        _build.lib()
    started = time.perf_counter()
    cfg = config(args.model)
    names = tuple(args.requests.split(','))
    model = build(cfg, device)
    emb64 = model.params.decoder.token_emb.detach().to(torch.float64)
    ref = run_requests(cfg, model, [n for n in names if n != 'refine_ref']
                       + ['refine'] * ('refine_ref' in names and 'refine' not in names))
    del model
    log('[unsharded] ' + ', '.join(f'{n} {ref[n][1]:.3f} s, {len(ref[n][0]["words"])} words'
                                   for n in ref if n[0] != '_'))
    report = {'device': device}
    for tp in (2, 1):
        got = spawn(args.model, device, [(tp, names)], ref.get('_aligned'))
        key = next(iter(got[0]))
        report[key] = compare(key, ref, [g[key] for g in got], 2 // tp, emb64)
    if args.cpu:
        cpu_ref = run_requests(cfg, build(cfg, 'cpu'), ('greedy',))
        report['cpu unsharded against the card'] = compare(
            'cpu unsharded against the card', ref, [cpu_ref], 1, emb64)
        got = spawn(args.model, 'cpu', [(2, ('greedy',))])
        key = next(iter(got[0]))
        report['cpu ' + key] = compare('cpu ' + key, cpu_ref, [g[key] for g in got], 1,
                                       emb64)
    log(f'[run] {time.perf_counter() - started:.1f} s')
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
