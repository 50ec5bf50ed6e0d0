"""Profiling hooks: optional ``torch.profiler`` tracing around task entry points
(port of stable_ts_tpu/profiling.py, which wraps ``jax.profiler``).

Enable by setting ``STABLE_TS_TPU_PROFILE=/path/to/tracedir`` or by using
:func:`profile_trace` directly::

    with stable_ts_tpu_torch.profiling.profile_trace('/tmp/trace'):
        model.transcribe(audio)

The trace records host activity always and the GPU's kernels when a card
is present, and is written as a Chrome trace (``*.pt.trace.json``, the
name TensorBoard's profiler plugin reads) under the directory; Perfetto
and ``chrome://tracing`` open it too. ``transcribe_stable`` enters
:func:`maybe_trace`, which does nothing unless the variable is set.
"""
import contextlib
import os
import socket
import time
from typing import Optional

_ENV = 'STABLE_TS_TPU_PROFILE'


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the host and, with a GPU, the device activity of the block
    into a Chrome trace under ``log_dir``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
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
