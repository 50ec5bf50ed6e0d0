"""The kernels of one greedy decoder step, three ways, on one card.

    python3 perfbench/step_kernels.py --workload <cell> [--seed <n>] [--sample-len <n>]

A check of the traced run's roofline rules (``roofline.py``): they must add
nothing to the CUDA graph that the greedy step captures. On the cell's
model and batch, one group of windows is transcribed three times under
``torch.profiler``, each after a run that warms it up:

- ``graph``: as the program runs, no harness: the kernels of one
  ``cudaGraphLaunch`` (one replayed step);
- ``eager``: the step graph switched off (``step_graph.graphable`` false),
  no harness: the kernels launched inside one ``decoder_step`` call;
- ``traced``: the harness's tracer installed as a ``--trace 1`` run
  installs it, the graph captured anew under it: the kernels of one
  replay.

``traced`` must launch the kernels of ``graph``, name for name and in
order; it exits 1 where they differ. Beside ``eager`` the functions are
compared by name and count and the differences printed: the graph's self
and cross entries are other instantiations of the same kernels (a
position and addresses read on the device), and the captured step reads
its position from a tensor. Prints one JSON line with the three lists'
lengths. The benchmark's own runs never run this.
"""
import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path.cwd()


def _events(prof):
    return prof.profiler.kineto_results.events()


def _kernels(events, corr_ok):
    """Device kernel names, in the order they ran, of the launches whose
    correlation id ``corr_ok`` accepts."""
    out = [(e.start_ns(), e.name()) for e in events
           if not str(e.device_type()).endswith('CPU')
           and not e.name().startswith('pb.') and corr_ok(e.correlation_id())]
    return [n for _, n in sorted(out)]


def one_replay(prof):
    """The kernels of the middle ``cudaGraphLaunch`` of the profile."""
    events = _events(prof)
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if str(e.device_type()).endswith('CPU')
                      and e.name().startswith('cudaGraphLaunch'))
    if not launches:
        return [], 0
    corr = launches[len(launches) // 2][1]
    return _kernels(events, lambda c: c == corr), len(launches)


def one_eager_step(prof):
    """The kernels launched inside the middle ``pb.step`` range."""
    events = _events(prof)
    cpu = [e for e in events if str(e.device_type()).endswith('CPU')]
    steps = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in cpu
                   if e.name() == 'pb.step')
    if not steps:
        return [], 0
    lo, hi = steps[len(steps) // 2]
    corrs = {e.correlation_id() for e in cpu if e.name().startswith('cu')
             and lo <= e.start_ns() <= hi}
    return _kernels(events, corrs.__contains__), len(steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', default='large-v3.longform')
    ap.add_argument('--seed', type=int, default=2_300_000_017)
    ap.add_argument('--sample-len', type=int, default=48)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('step_kernels needs a CUDA device', file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import roofline
    from perfbench.core import audio
    from perfbench.core.cell import Cell, load_json
    from perfbench.core.trace import Tracer
    from stable_ts_tpu_torch import _build, profiling
    from stable_ts_tpu_torch.models.whisper import decoding, step_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(load_json(ROOT / 'BENCHMARK.json'), args.workload, ROOT)
    cfg = cell.config
    _build.build()
    model, _ = cell.family.build(cfg, args.seed, getattr(torch, cfg['dtype']), 'cuda')
    wl = cell.kind.Workload(cell.traffic, cfg['dims'], args.seed, 'cuda')
    batch = cell.traffic['batch_size']
    pcm = audio.speech_like(30.0 * batch, (args.seed, 'steps'), 'cuda').pcm
    options = wl._options(args.sample_len)

    def profiled():
        model.transcribe_batched(pcm, **options)      # warms up (and captures)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.transcribe_batched(pcm, **options)
            torch.cuda.synchronize()
        return prof

    graph, n_graph = one_replay(profiled())

    graphable, step = step_graph.graphable, decoding.decoder_step

    def ranged_step(*a, **k):
        with record_function('pb.step'):
            return step(*a, **k)
    step_graph.graphable = lambda *a, **k: False
    decoding.decoder_step = ranged_step
    try:
        eager, n_eager = one_eager_step(profiled())
    finally:
        step_graph.graphable, decoding.decoder_step = graphable, step

    model.params.decoder._step_graph = None        # captured anew under the tracer
    with profiling.recording() as rec:
        tracer = Tracer(2.0, counters=lambda: rec.counters)
        tracer.ops_on()
        wl.trace_hooks(tracer, model)
        try:
            traced, n_traced = one_replay(profiled())
        finally:
            tracer.uninstall()
    captured = [c.label for calls in tracer.captures.values() for c in calls]

    def functions(names):
        return collections.Counter(roofline.kernel_function(n) for n in names)
    same_graph = traced == graph
    same_eager = functions(traced) == functions(eager)
    print(json.dumps(dict(
        workload=args.workload, graph=len(graph), eager=len(eager), traced=len(traced),
        graph_launches=n_graph, eager_steps=n_eager, traced_launches=n_traced,
        captured_wrapper_calls=collections.Counter(captured),
        traced_equals_graph=same_graph, traced_equals_eager_by_function=same_eager,
        functions=functions(traced),
        only_in_traced=functions(traced) - functions(eager),
        only_in_eager=functions(eager) - functions(traced))),
        flush=True)
    return 0 if graph and same_graph else 1


if __name__ == '__main__':
    sys.exit(main())
