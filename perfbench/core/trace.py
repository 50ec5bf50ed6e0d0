"""The traced run's instruments, all installed from the harness's side.

- Spans: a host clock around a call into one of the program's layers,
  with a device synchronize at each end, summed over the whole window.
- Counters: calls of a function.
- The decoder step's hook (``step_on``): counts the steps and keeps each
  step's host position, for the rules of the wrapper calls inside it and
  for the CUDA graph replay it issues.
- Kernel-wrapper records: each call of an ``ops/`` wrapper runs inside a
  ``record_function`` range while the profiler is on, and its operations
  and bytes are worked out from the shapes it was given
  (``perfbench/roofline.py``). While a CUDA stream captures a graph, each
  wrapper call is kept instead with its rule's arguments (shapes on the
  ``meta`` device, nothing launched), keyed by the step runner that
  captured; the replays' kernels are matched to those calls afterwards.
- A bounded profile: ``torch.profiler`` from the start of the window's
  second request (the first one may capture a graph) over
  ``profile_seconds``, stopped at the first span boundary after that. Its
  events are read in memory once the window has closed; no trace file is
  written. Idle gaps are named by the innermost span open at their
  middle, of the harness's spans and the program's own (its recorder,
  ``stable_ts_tpu_torch.profiling``), on the same clock.

Nothing here runs in a ``--trace 0`` run.
"""
import bisect
import collections
import functools
import heapq
import inspect
import sys
import time
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

from .. import roofline


def _patch_everywhere(orig, replacement, prefix='stable_ts_tpu_torch'):
    """Point every module attribute of the program that holds ``orig`` at
    ``replacement``; returns the (module, name) pairs changed."""
    changed = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == prefix or name.startswith(prefix + '.')):
            continue
        for attr, val in list(vars(mod).items()):
            if val is orig:
                setattr(mod, attr, replacement)
                changed.append((mod, attr))
    return changed


def _meta(x):
    """``x`` with each tensor replaced by one of its shape, strides and
    dtype on the ``meta`` device (no memory, no launch)."""
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device='meta')
    return x


class Call:
    """A wrapper call that a graph capture recorded: its label and rule,
    and the rule's arguments as shapes. ``pos_on_device``: the program
    passed the position as a device tensor, so each replay's host
    position stands in for it."""
    __slots__ = ('label', 'rule', 'args', 'pos_on_device')

    def __init__(self, label: str, rule: Callable, args: dict):
        self.label, self.rule = label, rule
        self.pos_on_device = isinstance(args.get('pos'), torch.Tensor)
        self.args = {k: _meta(v) for k, v in args.items()}

    def count(self, pos: Optional[int]):
        """(bytes, operations, peak) at host position ``pos``."""
        return self.rule(**(dict(self.args, pos=pos) if self.pos_on_device
                            else self.args))


@functools.lru_cache(maxsize=None)
def _signature(rule: Callable) -> inspect.Signature:
    return inspect.signature(rule)


def rule_arguments(rule: Callable, args: tuple, kwargs: dict) -> dict:
    """A wrapper call's arguments by the names of its rule's parameters."""
    bound = _signature(rule).bind(*args, **kwargs)
    bound.apply_defaults()
    return dict(bound.arguments)


def at_host_position(named: dict, host_pos: Optional[int]) -> dict:
    """``named`` with a position the program passed on the device replaced
    by ``host_pos``, the host position of the decoder step in progress
    (None where there is none): a rule never sees a device tensor."""
    if isinstance(named.get('pos'), torch.Tensor):
        named = dict(named, pos=host_pos)
    return named


class Tracer:
    def __init__(self, profile_seconds: float, counters: Callable[[], dict] = dict,
                 rules: dict = roofline.RULES, kernels: dict = roofline.KERNELS):
        """``counters()`` gives the program's recorder's counters now;
        ``rules`` and ``kernels``: the wrappers to wrap and their kernels,
        shaped like ``roofline.RULES`` and ``roofline.KERNELS`` (a cell's
        are ``Cell.rules`` and ``Cell.kernels``)."""
        self.profile_seconds = profile_seconds
        self.program_counters = counters
        self.rules, self.kernels = rules, kernels
        self.on_card = torch.cuda.is_available()
        self.spans = collections.defaultdict(lambda: [0.0, 0])
        self.counters = collections.Counter()
        self.intervals = []        # (name, t0_ns, t1_ns) while profiling
        self.op_calls = []         # (name, bytes, flops, peak, t0_ns) while profiling
        self.captures = weakref.WeakKeyDictionary()   # step runner -> [Call]
        self.replays = []          # (t0_ns, t1_ns, host pos, [Call] or None), profiling
        self._captured = None      # [Call] of the decoder step in progress
        self._pos = None           # its host position
        self._patches = []
        self._prof = None
        self._stopped = None       # (profiler, t0_ns, t1_ns) once stopped
        self._prof_t0 = None
        self._calib = None
        self.graph_captures = None  # the program's count at the profile's start, stop
        self.profile = None        # the reading of the profile, after read()

    # -- installing -----------------------------------------------------------------------

    def _replace(self, owner, attr, make):
        orig = getattr(owner, attr)
        new = make(orig)
        functools.update_wrapper(new, orig)
        if isinstance(owner, type(sys)):
            changed = _patch_everywhere(orig, new)
            if (owner, attr) not in changed:
                setattr(owner, attr, new)
                changed.append((owner, attr))
            self._patches += [(m, a, orig) for m, a in changed]
        else:
            setattr(owner, attr, new)
            self._patches.append((owner, attr, orig))
        return orig

    def span_on(self, owner, attr, name: str):
        """Time every call of ``owner.attr`` as span ``name`` and count the
        calls under the same name."""
        def make(fn):
            def wrapped(*args, **kwargs):
                with self.span(name):
                    out = fn(*args, **kwargs)
                self.counters[name] += 1
                self.checkpoint()
                return out
            return wrapped
        self._replace(owner, attr, make)

    def step_on(self, owner, attr, name: str):
        """Count every call of the decoder step ``owner.attr`` (arguments
        ``pos``, the host position, and ``graph``, the step runner) under
        ``name``. Inside it the wrappers' rules take ``pos`` for a position
        on the device. A call in which the program's counters show a graph
        capture keeps the wrapper calls captured under its runner; one that
        shows a replay, while profiling, keeps (its host clock, ``pos``,
        the runner's captured calls) for ``read_profile``."""
        def make(fn):
            params = list(inspect.signature(fn).parameters)

            def arg(args, kwargs, key):
                i = params.index(key) if key in params else len(args)
                return args[i] if i < len(args) else kwargs.get(key)

            def wrapped(*args, **kwargs):
                self.counters[name] += 1
                pos, runner = arg(args, kwargs, 'pos'), arg(args, kwargs, 'graph')
                c = self.program_counters()
                captures, replays = (c.get('decode.graph_captures', 0),
                                     c.get('decode.graph_replays', 0))
                outer = self._pos, self._captured
                self._pos, self._captured = pos, []
                t0 = time.perf_counter_ns()
                try:
                    out = fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter_ns()
                    captured = self._captured
                    self._pos, self._captured = outer
                c = self.program_counters()
                if runner is not None:
                    if c.get('decode.graph_captures', 0) > captures:
                        self.captures[runner] = captured
                    if (self._prof is not None
                            and c.get('decode.graph_replays', 0) > replays):
                        self.replays.append((t0, t1, pos, self.captures.get(runner)))
                self.checkpoint()
                return out
            return wrapped
        self._replace(owner, attr, make)

    def _capturing(self) -> bool:
        return self.on_card and torch.cuda.is_current_stream_capturing()

    def ops_on(self):
        """Wrap every kernel wrapper of ``ops/`` that the tracer has a rule for."""
        import importlib
        for (mod_name, attr), rule in self.rules.items():
            mod = importlib.import_module(f'stable_ts_tpu_torch.ops.{mod_name}')
            label = f'{mod_name}.{attr}'

            def make(fn, rule=rule, label=label):
                def wrapped(*args, **kwargs):
                    if self._capturing():
                        if self._captured is not None:
                            self._captured.append(Call(
                                label, rule, rule_arguments(rule, args, kwargs)))
                        return fn(*args, **kwargs)
                    if self._prof is None:
                        return fn(*args, **kwargs)
                    named = at_host_position(rule_arguments(rule, args, kwargs),
                                             self._pos)
                    if named.get('pos', 0) is None:   # no host position: unmatched
                        return fn(*args, **kwargs)
                    t0 = time.perf_counter_ns()
                    with torch.profiler.record_function(f'pb.op.{label}'):
                        out = fn(*args, **kwargs)
                    nbytes, flops, peak = rule(**named)
                    self.op_calls.append((label, nbytes, flops, peak, t0))
                    return out
                return wrapped
            self._replace(mod, attr, make)

    def uninstall(self):
        for owner, attr, orig in reversed(self._patches):
            setattr(owner, attr, orig)
        self._patches.clear()

    # -- spans ----------------------------------------------------------------------------

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    @contextmanager
    def span(self, name: str, sync: bool = True):
        if sync:
            self._sync()
        profiling = self._prof is not None
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if sync:
                self._sync()
            t1 = time.perf_counter_ns()
            rec = self.spans[name]
            rec[0] += (t1 - t0) / 1e9
            rec[1] += 1
            if profiling or self._prof is not None:
                self.intervals.append((name, t0, t1))

    # -- the bounded profile ------------------------------------------------------------

    def start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.on_card:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._sync()
        self.graph_captures = (self.program_counters().get('decode.graph_captures', 0),
                               None)
        self._prof_t0 = time.perf_counter_ns()
        with torch.profiler.record_function('pb.calib'):
            self._calib = time.perf_counter_ns()

    def checkpoint(self):
        """Stop the profile once its time is up (call at a span boundary)."""
        if (self._prof is not None and time.perf_counter_ns() - self._prof_t0
                >= self.profile_seconds * 1e9):
            self.stop_profile()

    def stop_profile(self):
        if self._prof is None:
            return
        self._sync()
        t1 = time.perf_counter_ns()
        self.graph_captures = (self.graph_captures[0],
                               self.program_counters().get('decode.graph_captures', 0))
        prof, self._prof = self._prof, None
        prof.stop()
        self._stopped = (prof, self._prof_t0, t1)

    def read(self, program_spans=()):
        """Read the stopped profile (after the window, once every span has
        closed); ``program_spans``: the program's recorder's spans."""
        if self._stopped is None:
            return
        prof, t0, t1 = self._stopped
        self._stopped = None
        spans = self.intervals + [(s.name, s.start_ns, s.end_ns) for s in program_spans]
        self.profile = read_profile(prof, t0, t1, self._calib, spans, self.op_calls,
                                    self.replays, self.kernels)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(intervals: List, points: List) -> List:
    """For each of ``points``, the name of the innermost of the (name,
    start, end) ``intervals`` open at it (the latest start, the earliest
    end among equal starts), or None."""
    order = sorted(range(len(points)), key=points.__getitem__)
    ivs = sorted(intervals, key=lambda iv: iv[1])
    out, heap, k = [None] * len(points), [], 0
    for i in order:
        p = points[i]
        while k < len(ivs) and ivs[k][1] <= p:
            name, s, e = ivs[k]
            heapq.heappush(heap, (-s, e, k, name))
            k += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)   # ended before p, so before every later point
        if heap:
            out[i] = heap[0][3]
    return out


def _labels_by_kernel(kernels: dict) -> Dict[str, set]:
    out = collections.defaultdict(set)
    for (mod, attr), names in kernels.items():
        for n in names:
            out[n].add(f'{mod}.{attr}')
    return out


def match_replay(kernels: List, calls: List,
                 by_wrapper: dict = roofline.KERNELS) -> tuple:
    """Pair a replay's kernels, (name, seconds) in the order they ran, with
    its capture's wrapper calls, in order and by kernel name (each
    wrapper's kernels in ``by_wrapper``, shaped like ``roofline.KERNELS``).
    A wrapper's kernel goes to the next call if that call's wrapper
    launches it, else to the call before if that one's does (a wrapper of
    several kernels); other kernels of a wrapper are unmatched. Returns
    ({call index: seconds}, [unmatched kernel names], calls left without a
    kernel)."""
    by_kernel = _labels_by_kernel(by_wrapper)
    times, unmatched, j = collections.defaultdict(float), [], 0
    for name, sec in kernels:
        labels = by_kernel.get(roofline.kernel_function(name))
        if not labels:
            continue                  # not a wrapper's kernel (linears, norms, copies)
        if j < len(calls) and calls[j].label in labels:
            times[j] += sec
            j += 1
        elif j > 0 and calls[j - 1].label in labels:
            times[j - 1] += sec
        else:
            unmatched.append(name)
    return times, unmatched, len(calls) - j


def read_profile(prof, t0_ns: int, t1_ns: int, calib_ns: int,
                 intervals: List, op_calls: List, replays: List = (),
                 by_wrapper: dict = roofline.KERNELS) -> Dict:
    """Busy and idle time, device time by kernel name and by span, and the
    device time of each kernel-wrapper call, from the profiler's events in
    memory. Host clocks are moved to the profiler's by the ``pb.calib``
    range, whose start was read on both.

    A kernel launched eagerly belongs to the wrapper call whose range holds
    the host event that launched it. A ``cudaGraphLaunch``'s kernels carry
    its correlation id; the decoder step call (``replays``) whose host
    clock holds the launch gives the capture's wrapper calls and the host
    position at which their rules count. Wrapper kernels matched to no
    call are counted by name (``unmatched``); ``by_wrapper`` names each
    wrapper's kernels, shaped like ``roofline.KERNELS``."""
    events = prof.profiler.kineto_results.events()
    launch_start = {}      # CUDA runtime call on the host, by correlation id
    graph_start = {}       # cudaGraphLaunch on the host, by correlation id
    annotations = collections.defaultdict(list)
    device = []
    offset = None
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith('CPU'):
            if name == 'pb.calib':
                offset = e.start_ns() - calib_ns
            elif name.startswith('pb.op.'):
                annotations[name[6:]].append((e.start_ns(), e.start_ns()
                                              + e.duration_ns()))
            elif name.startswith('cudaGraphLaunch'):
                graph_start[e.correlation_id()] = e.start_ns()
            elif name.startswith('cu'):
                launch_start[e.correlation_id()] = e.start_ns()
        elif not name.startswith('pb.'):    # not a range's device-side copy
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.correlation_id()))
    if offset is None:
        raise RuntimeError('profile: the calibration range is missing')
    lo, hi = t0_ns + offset, t1_ns + offset
    in_window = [d for d in device if d[1] > lo and d[0] < hi]
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _, _ in in_window])
    busy_ns = sum(e - s for s, e in busy)

    by_name = collections.Counter()
    for s, e, name, _ in in_window:
        by_name[name] += (e - s) / 1e9

    # idle gaps, named by the innermost span open at their middle
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    names = innermost([(n, s + offset, e + offset) for n, s, e in intervals],
                      [(s + e) / 2 for s, e in gaps])
    idle = collections.Counter()
    for (s, e), n in zip(gaps, names):
        idle[n or 'harness'] += (e - s) / 1e9

    # each eager wrapper call's device time: the kernels whose launching
    # host event started inside its range
    ranges = []
    for label, rs in annotations.items():
        ranges += [(s, e, label, i) for i, (s, e) in enumerate(rs)]
    ranges.sort()
    starts = [r[0] for r in ranges]
    call_time = collections.defaultdict(float)
    wrapper_kernel = set(_labels_by_kernel(by_wrapper))
    unmatched = collections.Counter()
    graph_kernels = collections.defaultdict(list)
    for s, e, name, corr in in_window:
        if corr in graph_start:
            continue
        host = launch_start.get(corr)
        k = bisect.bisect_right(starts, host) - 1 if host is not None else -1
        if k >= 0 and host <= ranges[k][1]:
            call_time[(ranges[k][2], ranges[k][3])] += (e - s) / 1e9
        elif roofline.kernel_function(name) in wrapper_kernel:
            unmatched[name] += 1
    nth = collections.Counter()
    bound_s = device_s = 0.0
    per_op = collections.defaultdict(lambda: [0.0, 0.0, 0])

    def add(label, nbytes, flops, peak, t):
        nonlocal bound_s, device_s
        b = max(nbytes / roofline.HBM_BYTES_PER_S, flops / peak)
        bound_s += b
        device_s += t
        rec = per_op[label]
        rec[0] += b
        rec[1] += t
        rec[2] += 1

    for label, nbytes, flops, peak, _ in op_calls:
        i = nth[label]
        nth[label] += 1
        t = call_time.get((label, i))
        if t:
            add(label, nbytes, flops, peak, t)

    # graph replays whose launch the profile holds: every kernel of each,
    # the ones that ran past the window's end included (the profile stops
    # after a synchronize), against its capture's calls at its position
    for s, e, name, corr in device:
        if corr in graph_start and lo <= graph_start[corr] <= hi:
            graph_kernels[corr].append((s, name, (e - s) / 1e9))
    steps = sorted(replays, key=lambda r: r[0])
    step_starts = [r[0] + offset for r in steps]
    n_replays = calls_left = 0
    for corr, kernels in graph_kernels.items():
        host = graph_start[corr]
        k = bisect.bisect_right(step_starts, host) - 1
        step = steps[k] if k >= 0 and host <= steps[k][1] + offset else None
        kernels = [(n, t) for _, n, t in sorted(kernels)]
        if step is None or step[3] is None:
            for n, _ in kernels:
                if roofline.kernel_function(n) in wrapper_kernel:
                    unmatched[n] += 1
            continue
        n_replays += 1
        calls = step[3]
        times, left, n_left = match_replay(kernels, calls, by_wrapper)
        unmatched.update(left)
        calls_left += n_left
        for i, t in times.items():
            add(calls[i].label, *calls[i].count(step[2]), t)
    return dict(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_ns / 1e9,
        device_ops=by_name.most_common(10), idle_gaps=idle.most_common(10),
        op_bound_s=bound_s, op_device_s=device_s,
        per_op={k: tuple(v) for k, v in per_op.items()},
        graph_launches=len(graph_kernels), graph_replays_matched=n_replays,
        unmatched=dict(unmatched), graph_calls_unmatched=calls_left,
        n_events=len(events))
