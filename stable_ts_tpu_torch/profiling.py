"""Profiling hooks: optional ``torch.profiler`` tracing around task entry
points (port of stable_ts_tpu/profiling.py, which wraps ``jax.profiler``),
and an in-memory recorder of the program's own spans and counters.

**Traces.** Enable by setting ``STABLE_TS_TPU_PROFILE=/path/to/tracedir``
or by using :func:`profile_trace` directly::

    with stable_ts_tpu_torch.profiling.profile_trace('/tmp/trace'):
        model.transcribe(audio)

The trace records host activity always and the GPU's kernels when a card
is present, and is written as a Chrome trace (``*.pt.trace.json``, the
name TensorBoard's profiler plugin reads) under the directory; Perfetto
and ``chrome://tracing`` open it too. ``transcribe_stable`` and
``transcribe_batched`` enter :func:`maybe_trace`, which does nothing
unless the variable is set. Inside :func:`profile_trace` the recorder
below is on and each of its spans is also a ``record_function`` range, so
the trace shows the batched driver's host phases and the decode loop's
steps above the kernels they launch. A ``torch.profiler`` started
elsewhere gets no ranges.

**The recorder.** Off by default; then each place the program records
costs a call and one check of a module flag: no clock read, no CUDA
event, no synchronize. Switch it on around the work to measure::

    with stable_ts_tpu_torch.profiling.recording() as rec:
        model.transcribe_batched(audio, batch_size=32)
    rec.self_ns('decode.step') / rec.counters['decode.steps']   # dispatch

Each :class:`Span` holds its name, its start and end on
``time.perf_counter_ns()``'s clock, its id, its parent's id (0 at the
top), its request's id and its thread; counters are named sums. Spans:

- ``batched.request``: one ``transcribe_batched`` call, a fresh request id.
- ``batched.group``: one step of the driver's pipeline. It reads and
  launches group ``group`` (``rows`` real windows, ``padded`` copies of
  the last one filling the batch), collects the group before it and
  assembles the one before that; the last steps only drain the pipeline
  and carry no group.
- ``host_load``, ``host_silence_predict``, ``host_window_stack``,
  ``host_window_prep``, ``host_upload_dispatch``, ``host_segmentize``,
  ``host_timing_launch``, ``host_timing_finish``,
  ``host_assemble_suppress``, ``host_result_build``, ``host_regroup``:
  the driver's host phases, summed in ``batched.HOST_PHASES`` as well.
- ``timing.wait``: inside ``host_timing_finish``, the wait for the
  word-timing pass on the side stream; the rest of that phase is the
  host's DTW traceback walk and word assembly.
- ``encoder``: ``WhisperTorch.embed_audio``, queuing the encoder (in the
  driver, inside ``host_upload_dispatch``).
- ``decode.prefill``: ``decode_launch``'s work before its loop.
- ``decode.step``: one iteration of the greedy loop; its one child,
  ``decode.sync_wait``, is the step's host read (are all rows done?), so
  the rest of the step is the host queuing the step's work.
- ``decode.collect``: downloading a decode's outputs, building results.

Counters: ``batched.windows_real`` and ``batched.windows_padded`` (the
windows of the groups launched), ``decode.tokens_kept`` (the tokens of
the real windows' results, from each group's first decode),
``decode.steps`` and ``decode.row_steps`` (the greedy loops' iterations,
and those times their rows), ``decode.graph_captures`` and
``decode.graph_replays`` (the greedy step's CUDA graphs captured, and
replayed, one replay a step: ``models/whisper/step_graph.py``),
``decode.eager_steps`` (decoder steps of any loop queued eagerly, kernel
by kernel), ``encoder.windows`` (real windows encoded)
and, on the card, ``encoder.device_ms``: the encoder's device time
between two CUDA timing events, read once a later host read
(``decode_collect``'s download) has waited for them.
"""
import contextlib
import dataclasses
import itertools
import os
import socket
import threading
import time
from typing import Dict, List, Optional

_ENV = 'STABLE_TS_TPU_PROFILE'


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the host and, with a GPU, the device activity of the block
    into a Chrome trace under ``log_dir``, with the program's spans as
    ranges; yields the profiler."""
    global _recording, _ranges
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    outer = _recording, _ranges
    if _recording is None:
        _recording = Recording()
    _ranges = True
    try:
        yield prof
    finally:
        _recording, _ranges = outer
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f'{socket.gethostname()}_{os.getpid()}.{time.time_ns()}'
                     '.pt.trace.json'))


def traced(task: str):
    """Decorator: run the wrapped task under :func:`maybe_trace`."""
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with maybe_trace(task):
                return fn(*args, **kwargs)
        return inner
    return wrap


_active = False


@contextlib.contextmanager
def maybe_trace(task: str, log_dir: Optional[str] = None):
    """Trace the block iff profiling is enabled (env var or explicit dir),
    into ``<dir>/<task>``.

    Nested tasks (e.g. refine auto-invoking align_words) reuse the
    outermost trace instead of starting a second one.
    """
    global _active
    target = log_dir or os.environ.get(_ENV)
    if not target or _active:
        yield
        return
    _active = True
    try:
        with profile_trace(os.path.join(target, task)):
            yield
    finally:
        _active = False


# -- the recorder ---------------------------------------------------------------------

_recording = None   # the Recording being filled; None while the recorder is off
_ranges = False     # inside profile_trace: spans are record_function ranges too


@dataclasses.dataclass
class Span:
    """A closed span; times in ``time.perf_counter_ns()``'s nanoseconds."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int        # the id of the span open around it, 0 at the top
    request: int       # the id of the request it belongs to, 0 outside one
    thread: int
    attrs: dict

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Open:
    """A span while it is open, a context manager; ``attrs`` go to the
    closed :class:`Span`."""
    __slots__ = ('rec', 'name', 'start_ns', 'id', 'parent', 'request', 'attrs',
                 'range', 'device_start')

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec._close(self, time.perf_counter_ns())
        return False


class _Off:
    """What :func:`span` gives while the recorder is off: does nothing,
    and is false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


class Recording:
    """The spans (closed, in the order they closed) and counters recorded
    while it was on; see the module's docstring for their names."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = threading.local()
        self._device = []   # (counter, start event, end event) not yet read

    def _stack(self) -> list:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, start_ns: int, request: bool = False,
             device_time: bool = False) -> _Open:
        stack = self._stack()
        top = stack[-1] if stack else None
        o = _Open()
        o.rec, o.name, o.start_ns, o.id = self, name, start_ns, next(self._ids)
        o.parent = top.id if top else 0
        o.request = (next(self._requests) if request
                     else top.request if top else 0)
        o.attrs, o.range, o.device_start = {}, None, None
        if _ranges:
            import torch
            o.range = torch.profiler.record_function(name)
            o.range.__enter__()
        if device_time:
            import torch
            o.device_start = torch.cuda.Event(enable_timing=True)
            o.device_start.record()
        stack.append(o)
        return o

    def _close(self, o: _Open, end_ns: int):
        stack = self._stack()
        if o not in stack:          # an enclosing span closed it already
            return
        while True:
            # spans that an exception left open inside this one are dropped
            top = stack.pop()
            if top.range is not None:
                top.range.__exit__(None, None, None)
            if top is o:
                break
        if o.device_start is not None:
            import torch
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._device.append((o.name + '.device_ms', o.device_start, end))
        self.spans.append(Span(o.name, o.start_ns, end_ns, o.id, o.parent,
                               o.request, threading.get_ident(), o.attrs))

    def close_named(self, name: str, end_ns: int):
        """Close the innermost open span called ``name`` on this thread."""
        for o in reversed(self._stack()):
            if o.name == name:
                self._close(o, end_ns)
                return

    def count(self, name: str, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def read_device_times(self):
        """Add the device times whose end event the device has passed to
        their counters; never waits."""
        pending = []
        for counter, start, end in self._device:
            if end.query():
                self.count(counter, start.elapsed_time(end))
            else:
                pending.append((counter, start, end))
        self._device = pending

    # -- reading ----------------------------------------------------------------------

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def total_ns(self, name: str) -> int:
        """The summed duration of the spans called ``name``."""
        return sum(s.ns for s in self.named(name))

    def self_ns(self, name: str) -> int:
        """The summed self time of the spans called ``name``: each one's
        duration less its children's (children nest, so never overlap)."""
        ids = {s.id for s in self.named(name)}
        return self.total_ns(name) - sum(s.ns for s in self.spans
                                         if s.parent in ids)


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters inside the block; yields
    the :class:`Recording`, complete when the block ends. A recording
    already on is set aside for the block and resumes after it."""
    global _recording
    outer, rec = _recording, Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer
        rec.read_device_times()


def span(name: str, *, request: bool = False, device_time: bool = False):
    """Span ``name``, for a ``with`` statement. ``request`` gives it, and the spans inside it, a fresh
    request id; ``device_time`` (the card only) also times the work queued
    on the current CUDA stream inside it, into counter
    ``<name>.device_ms``. While the recorder is off it returns a shared,
    false object that does nothing."""
    rec = _recording
    if rec is None:
        return _OFF
    return rec.open(name, time.perf_counter_ns(), request, device_time)


def open_at(name: str, start_ns: int):
    """Open span ``name`` from ``start_ns``, a clock reading the caller
    took (:func:`close_at` closes it)."""
    rec = _recording
    if rec is not None:
        rec.open(name, start_ns)


def close_at(name: str, end_ns: int):
    """Close the innermost open span called ``name`` at ``end_ns``."""
    rec = _recording
    if rec is not None:
        rec.close_named(name, end_ns)


def count(name: str, n=1):
    """Add ``n`` to counter ``name``."""
    rec = _recording
    if rec is not None:
        rec.count(name, n)


def read_device_times():
    """Read the device times the device has finished (call right after a
    host read that waited for it)."""
    rec = _recording
    if rec is not None and rec._device:
        rec.read_device_times()
