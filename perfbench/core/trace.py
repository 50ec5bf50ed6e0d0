"""The traced run's instruments, all installed from the harness's side.

- Spans: a host clock around a call into one of the program's layers,
  with a device synchronize at each end, summed over the whole window.
- Counters: calls of a function.
- Kernel-wrapper records: each call of an ``ops/`` wrapper runs inside a
  ``record_function`` range while the profiler is on, and its operations
  and bytes are worked out from the shapes it was given
  (``perfbench/roofline.py``).
- A bounded profile: ``torch.profiler`` over the first
  ``profile_seconds`` of the window, stopped at the first span boundary
  after that. Its events are read in memory; no trace file is written.

Nothing here runs in a ``--trace 0`` run.
"""
import bisect
import collections
import functools
import sys
import time
from contextlib import contextmanager
from typing import Dict, List

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


class Tracer:
    def __init__(self, profile_seconds: float):
        self.profile_seconds = profile_seconds
        self.on_card = torch.cuda.is_available()
        self.spans = collections.defaultdict(lambda: [0.0, 0])
        self.counters = collections.Counter()
        self.intervals = []        # (name, t0_ns, t1_ns) while profiling
        self._open = []            # [name, t0_ns] of the spans now open
        self.op_calls = []         # (name, bytes, flops, peak, t0_ns) while profiling
        self._patches = []
        self._prof = None
        self._prof_t0 = None
        self._calib = None
        self.profile = None        # the reading of the profile, after stop()

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

    def count_on(self, owner, attr, name: str):
        """Count every call of ``owner.attr`` under ``name``."""
        def make(fn):
            def wrapped(*args, **kwargs):
                self.counters[name] += 1
                out = fn(*args, **kwargs)
                self.checkpoint()
                return out
            return wrapped
        self._replace(owner, attr, make)

    def ops_on(self):
        """Wrap every kernel wrapper of ``ops/`` that roofline.py knows."""
        import importlib
        for (mod_name, attr), rule in roofline.RULES.items():
            mod = importlib.import_module(f'stable_ts_tpu_torch.ops.{mod_name}')
            label = f'{mod_name}.{attr}'

            def make(fn, rule=rule, label=label):
                def wrapped(*args, **kwargs):
                    if self._prof is None:
                        return fn(*args, **kwargs)
                    t0 = time.perf_counter_ns()
                    with torch.profiler.record_function(f'pb.op.{label}'):
                        out = fn(*args, **kwargs)
                    nbytes, flops, peak = rule(*args, **kwargs)
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
        entry = [name, t0]
        self._open.append(entry)
        try:
            yield
        finally:
            if sync:
                self._sync()
            t1 = time.perf_counter_ns()
            self._open.remove(entry)
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
        prof, self._prof = self._prof, None
        prof.stop()
        # spans still open run on past the profile: they end at its end
        spans = self.intervals + [(n, t0, t1) for n, t0 in self._open]
        self.profile = read_profile(prof, self._prof_t0, t1, self._calib,
                                    spans, self.op_calls)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(prof, t0_ns: int, t1_ns: int, calib_ns: int,
                 intervals: List, op_calls: List) -> Dict:
    """Busy and idle time, device time by kernel name and by harness span,
    and the device time of each kernel-wrapper call, from the profiler's
    events in memory. Host clocks are moved to the profiler's by the
    ``pb.calib`` range, whose start was read on both."""
    events = prof.profiler.kineto_results.events()
    launch_start = {}      # CUDA runtime call on the host, by correlation id
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
            elif name.startswith('cu'):
                launch_start[e.correlation_id()] = e.start_ns()
        elif not name.startswith('pb.'):    # not a range's device-side copy
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.correlation_id()))
    if offset is None:
        raise RuntimeError('profile: the calibration range is missing')
    lo, hi = t0_ns + offset, t1_ns + offset
    device = [d for d in device if d[1] > lo and d[0] < hi]
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _, _ in device])
    busy_ns = sum(e - s for s, e in busy)

    by_name = collections.Counter()
    for s, e, name, _ in device:
        by_name[name] += (e - s) / 1e9

    # idle gaps, named by the innermost harness span open at their middle
    # (spans of one name never overlap: each list is sorted and disjoint)
    by_span = collections.defaultdict(list)
    for n, s, e in intervals:
        by_span[n].append((s + offset, e + offset))
    for v in by_span.values():
        v.sort()
    span_starts = {n: [a for a, _ in v] for n, v in by_span.items()}
    idle = collections.Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        inner, inner_start = 'harness', None
        for n, v in by_span.items():
            k = bisect.bisect_right(span_starts[n], mid) - 1
            if k >= 0 and v[k][1] >= mid and (inner_start is None
                                              or v[k][0] > inner_start):
                inner, inner_start = n, v[k][0]
        idle[inner] += (e - s) / 1e9

    # each wrapper call's device time: the kernels whose launching host
    # event started inside its range
    ranges = []
    for label, rs in annotations.items():
        ranges += [(s, e, label, i) for i, (s, e) in enumerate(rs)]
    ranges.sort()
    starts = [r[0] for r in ranges]
    call_time = collections.defaultdict(float)
    for s, e, _, corr in device:
        host = launch_start.get(corr)
        if host is None:
            continue
        k = bisect.bisect_right(starts, host) - 1
        if k >= 0 and host <= ranges[k][1]:
            call_time[(ranges[k][2], ranges[k][3])] += (e - s) / 1e9
    nth = collections.Counter()
    bound_s = device_s = 0.0
    per_op = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for label, nbytes, flops, peak, _ in op_calls:
        i = nth[label]
        nth[label] += 1
        t = call_time.get((label, i))
        if not t:
            continue
        b = max(nbytes / roofline.HBM_BYTES_PER_S, flops / peak)
        bound_s += b
        device_s += t
        rec = per_op[label]
        rec[0] += b
        rec[1] += t
        rec[2] += 1
    return dict(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_ns / 1e9,
        device_ops=by_name.most_common(10), idle_gaps=idle.most_common(10),
        op_bound_s=bound_s, op_device_s=device_s,
        per_op={k: tuple(v) for k, v in per_op.items()},
        n_events=len(events))
