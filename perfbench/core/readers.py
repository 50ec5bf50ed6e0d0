"""The arithmetic of the metric readers (``perfbench/metrics/<name>.py``).

Each takes the run's context and returns a number, or None where the run
holds nothing to read. A share of a roofline or of a peak is never made
up: without a profile it is None, never 0. The program's own spans and
counters (``ctx.recording``, a ``stable_ts_tpu_torch.profiling.Recording``
of the traced window, None in an untraced run) feed the readers below
``driver_host_share``; their names are in that module's docstring.
"""
from .. import roofline


def audio_rate(ctx):
    """Audio seconds completed over the window's seconds."""
    if not ctx.requests or ctx.window_s <= 0:
        return None
    return sum(r['audio_s'] for r in ctx.requests) / ctx.window_s


def setup(ctx):
    return ctx.setup_s


def span_ms_per(ctx, span: str, per: str):
    """Milliseconds of span ``span`` over the count ``per`` (a counter)."""
    total, _ = ctx.spans.get(span, (0.0, 0))
    n = ctx.counters.get(per, 0)
    return 1000.0 * total / n if total and n else None


def encoder_ms_per_window(ctx):
    total, _ = ctx.spans.get('embed_audio', (0.0, 0))
    return 1000.0 * total / ctx.real_windows if total and ctx.real_windows else None


def driver_host_share(ctx):
    """The batched driver's host phases, the timing wait left out, over the
    window, in %."""
    phases = {k: v for k, v in ctx.host_phases.items() if k != 'host_timing_finish'}
    if not phases or ctx.window_s <= 0:
        return None
    return 100.0 * sum(phases.values()) / ctx.window_s


def _recorded(ctx, spans=(), counters=(), any_span=False):
    """The window's recording if it holds the spans named (with
    ``any_span``, one of them at least) and every counter named, else
    None."""
    rec = getattr(ctx, 'recording', None)
    if rec is None or not all(rec.counters.get(c) for c in counters):
        return None
    held = [bool(rec.named(s)) for s in spans]
    return rec if (any(held) if any_span else all(held)) else None


def decode_dispatch_ms_per_step(ctx):
    """The greedy loop's step spans less their host read: the host
    queuing a step's work, in ms a step."""
    rec = _recorded(ctx, ['decode.step'], ['decode.steps'])
    if rec is None:
        return None
    return 1e-6 * rec.self_ns('decode.step') / rec.counters['decode.steps']


def decode_sync_wait_ms_per_step(ctx):
    """The step's one host read (are all rows done?), in ms a step."""
    rec = _recorded(ctx, ['decode.sync_wait'], ['decode.steps'])
    if rec is None:
        return None
    return 1e-6 * rec.total_ns('decode.sync_wait') / rec.counters['decode.steps']


def decode_row_use(ctx):
    """Tokens the real windows kept over the rows the greedy loops ran, in %."""
    rec = _recorded(ctx, (), ['decode.tokens_kept', 'decode.row_steps'])
    if rec is None:
        return None
    return 100.0 * rec.counters['decode.tokens_kept'] / rec.counters['decode.row_steps']


def decode_graph_share(ctx):
    """Decoder steps replayed from a CUDA graph over all decoder steps, in %."""
    rec = getattr(ctx, 'recording', None)
    if rec is None:
        return None
    replays = rec.counters.get('decode.graph_replays', 0)
    steps = replays + rec.counters.get('decode.eager_steps', 0)
    return 100.0 * replays / steps if steps else None


def timing_host_ms_per_window(ctx):
    """The word timing's host work (``host_timing_finish`` less its wait
    for the side stream, ``timing.wait``) in ms a real window."""
    rec = _recorded(ctx, ['host_timing_finish'], ['batched.windows_real'])
    if rec is None:
        return None
    ns = rec.total_ns('host_timing_finish') - rec.total_ns('timing.wait')
    return 1e-6 * ns / rec.counters['batched.windows_real']


def encoder_device_ms_per_window(ctx):
    """The encoder's device time between CUDA events (the card only) in ms
    a real window encoded."""
    rec = _recorded(ctx, (), ['encoder.device_ms', 'encoder.windows'])
    if rec is None:
        return None
    return rec.counters['encoder.device_ms'] / rec.counters['encoder.windows']


READ_PHASES = ('host_load', 'host_silence_predict', 'host_window_stack')
ASSEMBLE_PHASES = ('host_segmentize', 'host_assemble_suppress', 'host_result_build',
                   'host_regroup')


def host_phases_ms_per_window(ctx, phases):
    """The summed spans of the driver's host ``phases``, in ms a real window."""
    rec = _recorded(ctx, phases, ['batched.windows_real'], any_span=True)
    if rec is None:
        return None
    ns = sum(rec.total_ns(p) for p in phases)
    return 1e-6 * ns / rec.counters['batched.windows_real']


def kernel_roofline(ctx):
    p = ctx.profile
    if not p or p['op_device_s'] <= 0:
        return None
    return 100.0 * p['op_bound_s'] / p['op_device_s']


def wrapper_roofline(ctx, label: str):
    """One kernel wrapper's (``<module>.<wrapper>``, a key of the cell's
    rules) summed bound time over its summed device time in the profile,
    in %; None where the profile holds no device time of it."""
    p = ctx.profile
    rec = p['per_op'].get(label) if p else None
    if rec is None or rec[1] <= 0:
        return None
    return 100.0 * rec[0] / rec[1]


def device_idle(ctx):
    p = ctx.profile
    if not p or p['window_s'] <= 0 or p['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])


def mfu(ctx):
    if not ctx.useful_flops or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.useful_flops / (ctx.window_s * roofline.PEAK_BF16)
