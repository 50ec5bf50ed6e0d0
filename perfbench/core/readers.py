"""The arithmetic of the metric readers (``perfbench/metrics/<name>.py``).

Each takes the run's context and returns a number, or None where the run
holds nothing to read. A share of a roofline or of a peak is never made
up: without a profile it is None, never 0.
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


def kernel_roofline(ctx):
    p = ctx.profile
    if not p or p['op_device_s'] <= 0:
        return None
    return 100.0 * p['op_bound_s'] / p['op_device_s']


def device_idle(ctx):
    p = ctx.profile
    if not p or p['window_s'] <= 0 or p['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])


def mfu(ctx):
    if not ctx.useful_flops or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.useful_flops / (ctx.window_s * roofline.PEAK_BF16)
