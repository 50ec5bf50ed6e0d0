"""One run of one cell: set-up, the measured window, the readers, the check.

The window is a closed loop of one client: request ``i``'s inputs are made
from the seed (outside the clock), then served; the window's time is the
sum of the service times, and it closes when the first request that ends
after ``seconds`` ends. Every request of the window counts, whole.

After the window the program's state is freed and the reference, built
anew from the seed, judges a sample of what the program served (the
kind's ``sample`` and ``check``). Each compared number is held against
its limit in ``perfbench/limits/<cell>.json``.

The model, its reference and the program's host phases come from the
configuration's family (``perfbench/families/<family>.py``).
"""
import gc
import math
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

from .cell import Cell, load_json
from .trace import Tracer

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'stable_ts_tpu')


def forbidden_modules(modules=None):
    """Top-level names among ``modules`` (default: the loaded ones) that
    the run must not hold, compared whole (``stable_ts_tpu_torch`` is not
    ``stable_ts_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def host_counters():
    """The machine's CPU jiffies (all, steal) from /proc/stat, this
    process's CPU seconds and involuntary context switches, and the count
    of full garbage collections: read outside the window, on both sides."""
    import gc
    import resource
    try:
        with open('/proc/stat') as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
        jiffies, steal = sum(cpu[:8]), cpu[7]
    except (OSError, ValueError, IndexError):
        jiffies = steal = 0
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(jiffies=jiffies, steal=steal, cpu_s=ru.ru_utime + ru.ru_stime,
                nivcsw=ru.ru_nivcsw, full_gc=gc.get_stats()[2]['collections'])


def hold(numbers: dict, limits: dict):
    """Each compared number beside its limit, and whether all hold (a
    missing number does not)."""
    compared, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name, math.inf)
        ok = ok and bool(value <= spec['limit'])
        compared[name] = dict(value=value, limit=spec['limit'])
    return compared, ok


def _sync(torch, device):
    if str(device).startswith('cuda'):
        torch.cuda.synchronize()


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = 'cuda', log=print,
             configure=None, with_control: bool = False) -> dict:
    """Run the cell; returns the result line's object (without printing).
    ``configure(cell)`` may change the loaded cell before anything runs
    (the CPU tests shrink it). ``with_control`` also judges the control,
    the family's reference in the precision below the configuration's put
    in the program's place on the same inputs, under the key ``control``
    (the benchmark's own runs never do)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    bench = load_json(root / 'BENCHMARK.json')
    cell = Cell(bench, workload, root)
    if configure is not None:
        configure(cell)
    cfg, family = cell.config, cell.family
    on_card = device.startswith('cuda')

    from stable_ts_tpu_torch import _build
    if on_card:
        torch.zeros(1, device=device)
        _sync(torch, device)
    t_context = time.perf_counter()
    if on_card:
        _build.build()
        _build.lib()
    t_build = time.perf_counter()

    dtype = getattr(torch, cfg['dtype'])
    model, marks = family.build(cfg, seed, dtype, device)
    _sync(torch, device)
    t_weights = time.perf_counter()
    wl = cell.kind.Workload(cell.traffic, cfg['dims'], seed, device)
    wl.warmup(model)
    _sync(torch, device)
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    parts, at = [], t_build
    for name, t in marks:
        parts.append(f'{name} {t - at:.3f}')
        at = t
    log(f'[setup] {setup_s:.3f} s: imports and CUDA context '
        f'{t_context - t_start:.3f}, build check {t_build - t_context:.3f}, '
        f'weights {t_weights - t_build:.3f} ({", ".join(parts)}), '
        f'warm-up {t_ready - t_weights:.3f}')

    tracer = recorder = recording = None
    if trace:
        tracer = Tracer(cell.traffic.get('profile_seconds', 2.0),
                        counters=lambda: recording.counters if recording else {},
                        rules=cell.rules, kernels=cell.kernels)
        tracer.ops_on()
        wl.trace_hooks(tracer, model)
        wl.span = tracer.span
    wl.install(model)
    phases = family.host_phases()
    phases.clear()
    if trace:       # the program's own spans and counters
        from stable_ts_tpu_torch import profiling
        recorder = profiling.recording()
        recording = recorder.__enter__()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = host_counters()
    served_s, attempted, failed, i = 0.0, 0, 0, 0
    while served_s < seconds:
        req = wl.make_request(i)
        if tracer and i == 1:     # the first request may capture a graph
            tracer.start_profile()
        i += 1
        attempted += 1
        t0 = time.perf_counter()
        try:
            with (tracer.span('request', sync=False) if tracer else nullcontext()):
                rec = wl.serve(model, req)
        except Exception:       # a failed request is counted and reported
            traceback.print_exc(file=sys.stderr)
            rec = None
        t1 = time.perf_counter()
        served_s += t1 - t0
        if rec is None:
            failed += 1
        else:
            rec['latency'] = t1 - t0
            wl.served.append(rec)
        if tracer:
            tracer.checkpoint()
    if tracer:
        tracer.stop_profile()
    _sync(torch, device)
    if recorder:
        recorder.__exit__(None, None, None)   # reads the device times, now all done
    after = host_counters()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    host_phases = dict(phases)
    wl.uninstall(model)
    if tracer:
        tracer.uninstall()
        tracer.read(recording.spans)
    log(f'[window] {served_s:.3f} s, {attempted} requests, {failed} failed, '
        f'{sum(r["audio_s"] for r in wl.served):.1f} audio s; host phases '
        + ', '.join(f'{k} {v:.3f}' for k, v in sorted(host_phases.items())))
    d = {k: after[k] - before[k] for k in after}
    log(f'[host] steal {100.0 * d["steal"] / max(d["jiffies"], 1):.2f} % of the '
        f'machine\'s CPU time; this process {d["cpu_s"]:.3f} CPU s, '
        f'{d["nivcsw"]} involuntary context switches, {d["full_gc"]} full '
        f'collections')
    log('[requests] ' + '; '.join(
        ' '.join(f'{k} {v:.3f}' if isinstance(v, float) else f'{k} {v}'
                 for k, v in r.items() if isinstance(v, (int, float)))
        for r in wl.served))

    ctx = SimpleNamespace(
        requests=wl.served, window_s=served_s, setup_s=setup_s,
        spans={k: tuple(v) for k, v in (tracer.spans if tracer else {}).items()},
        counters=dict(tracer.counters) if tracer else {},
        profile=tracer.profile if tracer else None, host_phases=host_phases,
        recording=recording,
        useful_flops=wl.useful_flops(), real_windows=wl.real_windows())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = Cell.reader(m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = dict(value=value, unit=m['unit'])

    # the program's state goes before the reference comes
    items = wl.sample()
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judge = family.judge(cfg, seed, dtype, device)
    numbers = wl.check(judge, items)
    log(f'[check] {len(items)} items in {time.perf_counter() - t_check:.3f} s: '
        f'{numbers}')
    control = None
    if with_control:
        low = family.judge(cfg, seed, dtype, device, control=True)
        control = wl.check(judge, wl.control(low, items))
        del low
        log(f'[control] {control}')
    del judge

    compared, held = hold(numbers, cell.limits)
    correct = attempted > 0 and failed == 0 and bool(items) and held
    out = dict(correct=bool(correct), attempted=attempted, failed=failed,
               metrics=metrics,
               device=dict(platform='gpu' if on_card else 'cpu',
                           kind=torch.cuda.get_device_name(0) if on_card else 'cpu',
                           count=1, memory_peak_bytes=int(memory_peak)))
    if tracer and tracer.profile:
        p = tracer.profile
        out['device'].update(busy_s=p['busy_s'], window_s=p['window_s'])
        out['breakdown'] = dict(device_ops=[[n, s] for n, s in p['device_ops']],
                                idle_gaps=[[n, s] for n, s in p['idle_gaps']])
        log(f'[profile] {p["n_events"]} events; decode.graph_captures at the '
            f'start {tracer.graph_captures[0]}, at the stop {tracer.graph_captures[1]}; '
            f'{p["graph_launches"]} graph launches, {p["graph_replays_matched"]} '
            f'matched to a replayed step; unmatched kernels {p["unmatched"]}, '
            f'captured calls without a kernel {p["graph_calls_unmatched"]}; '
            f'per wrapper (bound s, device s, calls): {p["per_op"]}')
    if tracer:
        log(f'[trace] spans {ctx.spans}; counters {ctx.counters}; program '
            f'counters {recording.counters}')
    if control is not None:
        out['readings'], out['control'] = numbers, control
        out['control_compared'], out['control_correct'] = hold(control, cell.limits)
    out['compared'] = compared
    return out
