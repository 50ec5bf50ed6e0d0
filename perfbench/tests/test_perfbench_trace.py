"""The traced run's instruments on the CPU: rules that launch nothing, the
host position handed to a rule, graph replays matched to their capture's
wrapper calls in a synthetic profile, idle gaps named by the innermost
span of the harness's and the program's, and the readers of the
program's recorder."""
import collections
import functools
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench import roofline
from perfbench.core import readers
from perfbench.core.engine import run_cell
from perfbench.core.trace import Call, Tracer, innermost, match_replay, read_profile
from stable_ts_tpu_torch.profiling import Recording, Span

ROOT = Path(__file__).resolve().parents[2]
D, H, B, S, L = 64, 2, 4, 32, 2


def t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


# one call of each wrapper's rule, by (module, wrapper), on CPU tensors
EXAMPLES = {
    ('flash_attn', 'flash_attention'): lambda: (
        t(B, 10, D), t(B, 15, D), t(B, 15, D), H, 0.125),
    ('self_attn', 'self_attn_decode'): lambda: (
        t(B, D), t(B, S, D, dtype=torch.int8), t(B, S, D, dtype=torch.int8), t(B, S),
        t(B, S), 5, H),
    ('cross_attn', 'cross_attn_decode'): lambda: (
        t(B, D), t(L, B, 2, 15, D, dtype=torch.int8), t(L, B, 2, 15), 1, 15, H),
    ('cross_attn', 'cross_attn_decode_indirect'): lambda: (
        t(B, D), t(L, B, 2, 15, D, dtype=torch.int8), t(L, B, 2, 15),
        t(2, dtype=torch.int64), 1, 15, H),
    ('logit_epilogue', 'fused_logit_aggregates'): lambda: (
        t(B, D), t(100, D, dtype=torch.bfloat16), t(100), t(100),
        t(B, 4, dtype=torch.int32), 90, 80),
    ('vocab_proj', 'vocab_proj'): lambda: (t(B, D), t(100, D)),
    ('woq_matmul', 'woq_matmul'): lambda: (
        t(B, D), t(3 * D, D, dtype=torch.int8), t(3 * D)),
    ('dtw', 'dtw_cost'): lambda: (t(B, 12, 15),),
}
INDIRECT = ('cross_attn', 'cross_attn_decode_indirect')


class Launches(TorchDispatchMode):
    """Every ATen operation run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_every_rule_has_an_example_and_kernels():
    assert set(EXAMPLES) == set(roofline.RULES) == set(roofline.KERNELS)


@pytest.mark.parametrize('key', sorted(roofline.RULES), ids='.'.join)
def test_rule_launches_nothing(key):
    args = EXAMPLES[key]()
    with Launches() as seen:
        nbytes, flops, peak = roofline.RULES[key](*args)
    assert seen.ops == []
    assert nbytes > 0 and flops > 0 and peak > 0


def test_the_mode_sees_a_launch():
    with Launches() as seen:
        torch.zeros(()) + 1
    assert seen.ops


def test_self_rule_refuses_a_device_position():
    args = list(EXAMPLES[('self_attn', 'self_attn_decode')]())
    args[5] = torch.tensor(5)
    with pytest.raises(TypeError), Launches() as seen:
        roofline.self_attn_decode(*args)
    assert seen.ops == []


def test_indirect_cross_counts_as_the_direct_entry():
    q, kv, sc, bases, layer, s, heads = EXAMPLES[INDIRECT]()
    assert (roofline.cross_attn_decode_indirect(q, kv, sc, bases, layer, s, heads)
            == roofline.cross_attn_decode(q, kv, sc, layer, s, heads))


def test_kernel_function_names():
    f = roofline.kernel_function
    assert f('void (anonymous namespace)::cross_cluster_kernel<signed char, 64, true>'
             '(float const*, signed char const*)') == 'cross_cluster_kernel'
    assert f('void (anonymous namespace)::epilogue_merge_kernel(float const*, float*, '
             'int)') == 'epilogue_merge_kernel'
    assert f('nvjet_tst_128x192_64x5_2x1_v_bz_coopB_bias_TNN') == (
        'nvjet_tst_128x192_64x5_2x1_v_bz_coopB_bias_TNN')
    assert f('void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor'
             '<float>, std::array<char*, 1ul> >(int)') == 'vectorized_elementwise_kernel'


# -- the tracer's hooks ----------------------------------------------------------------

class Runner:
    """Stands for a step runner: the tracer keys its capture by it."""


def test_capture_and_eager_calls_see_only_host_positions(monkeypatch):
    """A decoder step that captures records its wrapper calls as shapes,
    keyed by its runner, with the position left to each replay; an eager
    call with a device position gives its rule the step's host position."""
    seen = []
    rule = roofline.self_attn_decode

    @functools.wraps(rule)
    def spy(*args, **kwargs):
        seen.append(kwargs.get('pos', args[5] if len(args) > 5 else None))
        return rule(*args, **kwargs)
    monkeypatch.setitem(roofline.RULES, ('self_attn', 'self_attn_decode'), spy)
    from stable_ts_tpu_torch.ops import cross_attn, self_attn
    counts = {}
    tracer = Tracer(2.0, counters=lambda: counts)
    capturing = [False]
    tracer._capturing = lambda: capturing[0]
    q, k, v, ks, vs, _, heads = EXAMPLES[('self_attn', 'self_attn_decode')]()
    qc, kv, sc, layer, s, _ = EXAMPLES[('cross_attn', 'cross_attn_decode')]()

    def step(decoder, tokens, pos, graph=None):
        pos_dev = torch.tensor(pos)
        if graph is not None and not counts:        # the first call captures
            capturing[0] = True
            self_attn.self_attn_decode(q, k, v, ks, vs, pos_dev, heads)
            cross_attn.cross_attn_decode(qc, kv, sc, layer, s, heads)
            capturing[0] = False
            counts['decode.graph_captures'] = 1
        if graph is not None:
            counts['decode.graph_replays'] = counts.get('decode.graph_replays', 0) + 1
        else:
            self_attn.self_attn_decode(q, k, v, ks, vs, pos_dev, heads)
    program = SimpleNamespace(step=step)
    tracer.ops_on()
    tracer.step_on(program, 'step', 'decoder_step')
    try:
        runner = Runner()
        program.step(None, None, 7, graph=runner)
        tracer._prof, tracer._prof_t0 = object(), time.perf_counter_ns()   # profiling
        program.step(None, None, 9, graph=runner)
        program.step(None, None, 11)
        tracer._prof = None
    finally:
        tracer.uninstall()
    assert self_attn.self_attn_decode.__name__ == 'self_attn_decode'
    calls = tracer.captures[runner]
    assert [c.label for c in calls] == ['self_attn.self_attn_decode',
                                        'cross_attn.cross_attn_decode']
    assert calls[0].pos_on_device and not calls[1].pos_on_device
    assert all(a.device.type == 'meta' for c in calls for a in c.args.values()
               if isinstance(a, torch.Tensor))
    assert calls[0].count(9) == rule(q, k, v, ks, vs, 9, heads)
    assert calls[1].count(9) == roofline.cross_attn_decode(qc, kv, sc, layer, s, heads)
    assert [(r[2], r[3]) for r in tracer.replays] == [(9, calls)]
    assert tracer.counters['decoder_step'] == 3
    (label, nbytes, flops, _, _), = tracer.op_calls
    assert label == 'self_attn.self_attn_decode'
    assert (nbytes, flops) == rule(q, k, v, ks, vs, 11, heads)[:2]
    # the eager call's rule ran at 11, the capture's at the replay's 9
    assert seen == [11, 9] and all(isinstance(p, int) for p in seen)


# -- a synthetic profile -------------------------------------------------------------------

class Ev:
    def __init__(self, name, cpu, start, dur, corr=0):
        self._n, self._cpu, self._s, self._d, self._c = name, cpu, start, dur, corr

    def name(self):
        return self._n

    def device_type(self):
        return 'DeviceType.CPU' if self._cpu else 'DeviceType.CUDA'

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


OFFSET = 1_000_000       # the profiler's clock less the host's
SELF_K = ('void (anonymous namespace)::decode_attn_kernel<signed char, 64, false, true>'
          '(float)')
CROSS_K = 'void (anonymous namespace)::cross_cluster_kernel<signed char, 64, true>(float)'


def _graph_calls():
    q, k, v, ks, vs, _, heads = EXAMPLES[('self_attn', 'self_attn_decode')]()
    qc, kv, sc, bases, layer, s, _ = EXAMPLES[INDIRECT]()
    return [Call('self_attn.self_attn_decode', roofline.self_attn_decode,
                 dict(q=q, k=k, v=v, k_scale=ks, v_scale=vs, pos=torch.tensor(0),
                      n_head=heads, anc=None, q_per_kv=1)),
            Call('cross_attn.cross_attn_decode_indirect',
                 roofline.cross_attn_decode_indirect,
                 dict(q=qc, kv=kv, sc=sc, bases=bases, layer=layer, s=s, n_head=heads,
                      bits=8))]


def _bound(counted):
    nbytes, flops, peak = counted
    return max(nbytes / roofline.HBM_BYTES_PER_S, flops / peak)


def test_graph_replay_is_attributed_to_the_capture_at_its_position():
    calls = _graph_calls()
    h = OFFSET
    events = [
        Ev('pb.calib', True, 100 + h, 10),
        Ev('cudaGraphLaunch', True, 2_500_000 + h, 5_000, corr=77),
        Ev('nvjet_tst_64x8', False, 3_000_000 + h, 1_000, corr=77),
        Ev(SELF_K, False, 3_010_000 + h, 4_000, corr=77),
        Ev('void at::native::elementwise_kernel<128, 2>(int)', False, 3_020_000 + h, 500,
           corr=77),
        Ev(CROSS_K, False, 3_030_000 + h, 10_000, corr=77),
        Ev(SELF_K, False, 3_050_000 + h, 100, corr=77),       # no call left for it
        # an eager wrapper call: its kernel launched inside its range
        Ev('pb.op.dtw.dtw_cost', True, 6_000_000 + h, 100_000),
        Ev('cudaLaunchKernel', True, 6_050_000 + h, 1_000, corr=90),
        Ev('void (anonymous namespace)::dtw_cost_kernel<4>(float)', False, 6_200_000 + h,
           50_000, corr=90),
        # a wrapper's kernel launched outside any range
        Ev('cudaLaunchKernel', True, 8_000_000 + h, 1_000, corr=91),
        Ev(SELF_K, False, 8_100_000 + h, 2_000, corr=91),
    ]
    dtw = roofline.dtw_cost(*EXAMPLES[('dtw', 'dtw_cost')]())
    p = read_profile(_prof(events), 0, 10_000_000, 100, [],
                     [('dtw.dtw_cost', *dtw, 6_000_000)],
                     [(2_000_000, 2_900_000, 40, calls)])
    self_b, cross_b = _bound(calls[0].count(40)), _bound(calls[1].count(40))
    assert p['per_op']['self_attn.self_attn_decode'] == pytest.approx((self_b, 4e-6, 1))
    assert p['per_op']['cross_attn.cross_attn_decode_indirect'] == pytest.approx(
        (cross_b, 1e-5, 1))
    assert p['per_op']['dtw.dtw_cost'] == pytest.approx((_bound(dtw), 5e-5, 1))
    assert p['op_bound_s'] == pytest.approx(self_b + cross_b + _bound(dtw))
    assert p['op_device_s'] == pytest.approx(4e-6 + 1e-5 + 5e-5)
    assert p['unmatched'] == {SELF_K: 2}
    assert (p['graph_launches'], p['graph_replays_matched'],
            p['graph_calls_unmatched']) == (1, 1, 0)
    # the self rule counts the replay's position's keys, not the cache's
    assert calls[0].count(40) != calls[0].count(S - 1)


def test_a_replay_without_its_capture_is_unmatched():
    events = [Ev('pb.calib', True, 100 + OFFSET, 10),
              Ev('cudaGraphLaunch', True, 2_500_000 + OFFSET, 5_000, corr=5),
              Ev(CROSS_K, False, 3_000_000 + OFFSET, 1_000, corr=5)]
    p = read_profile(_prof(events), 0, 10_000_000, 100, [], [],
                     [(2_000_000, 2_900_000, 40, None)])
    assert p['unmatched'] == {CROSS_K: 1} and p['op_device_s'] == 0.0
    assert p['graph_replays_matched'] == 0


def test_match_replay_in_order_and_by_name():
    calls = _graph_calls() * 2
    kernels = [(SELF_K, 1.0), ('nvjet', 9.0), (CROSS_K, 2.0), (SELF_K, 3.0), (CROSS_K, 4.0),
               (CROSS_K, 5.0)]
    times, unmatched, left = match_replay(kernels, calls)
    # a wrapper of several kernels keeps the one after its first
    assert dict(times) == {0: 1.0, 1: 2.0, 2: 3.0, 3: 4.0 + 5.0}
    assert unmatched == [] and left == 0
    times, unmatched, left = match_replay([(CROSS_K, 1.0), (SELF_K, 2.0)], calls)
    assert dict(times) == {0: 2.0} and unmatched == [CROSS_K] and left == 3


def test_innermost_span():
    spans = [('request', 0, 100), ('batched.group', 10, 90), ('decode.step', 20, 30),
             ('decode.sync_wait', 25, 29), ('greedy_loop', 15, 80), ('host_load', 85, 88)]
    assert innermost(spans, [26, 22, 50, 86, 95, 5, 200]) == [
        'decode.sync_wait', 'decode.step', 'greedy_loop', 'host_load', 'request',
        'request', None]
    # of two spans that start together the shorter is the inner
    assert innermost([('a', 0, 10), ('b', 0, 5)], [3, 7]) == ['b', 'a']


def test_idle_gaps_named_by_the_harness_and_the_program():
    h = OFFSET
    events = [Ev('pb.calib', True, h, 10),
              Ev('k1', False, 1_000 + h, 1_000),      # busy 1000-2000
              Ev('k2', False, 5_000 + h, 1_000)]      # busy 5000-6000
    spans = [('request', 0, 10_000), ('greedy_loop', 0, 8_000),
             ('decode.step', 2_000, 5_000), ('decode.sync_wait', 3_000, 5_000),
             ('host_segmentize', 6_000, 9_000)]
    p = read_profile(_prof(events), 0, 10_000, 0, spans, [])
    # gaps 0-1000 (mid 500: greedy_loop), 2000-5000 (mid 3500: sync wait),
    # 6000-10000 (mid 8000: host_segmentize)
    assert dict(p['idle_gaps']) == pytest.approx({
        'greedy_loop': 1e-6, 'decode.sync_wait': 3e-6, 'host_segmentize': 4e-6})
    assert p['busy_s'] == pytest.approx(2e-6)


# -- the readers of the program's recorder -------------------------------------------------

def _span(name, start, end, id, parent=0):
    return Span(name, start, end, id, parent, 1, 0, {})


def _recording():
    rec = Recording()
    ms = 1_000_000
    rec.spans = [
        _span('decode.sync_wait', 2 * ms, 3 * ms, 2, parent=1),
        _span('decode.step', 0, 10 * ms, 1),
        _span('decode.sync_wait', 12 * ms, 15 * ms, 4, parent=3),
        _span('decode.step', 10 * ms, 16 * ms, 3),
        _span('timing.wait', 20 * ms, 24 * ms, 6, parent=5),
        _span('host_timing_finish', 20 * ms, 30 * ms, 5),
        _span('host_load', 30 * ms, 32 * ms, 7),
        _span('host_silence_predict', 32 * ms, 35 * ms, 8),
        _span('host_window_stack', 35 * ms, 36 * ms, 9),
        _span('host_segmentize', 40 * ms, 41 * ms, 10),
        _span('host_assemble_suppress', 41 * ms, 43 * ms, 11),
        _span('host_result_build', 43 * ms, 46 * ms, 12),
        _span('host_regroup', 46 * ms, 50 * ms, 13),
    ]
    rec.counters = {'decode.steps': 2, 'decode.row_steps': 64, 'decode.tokens_kept': 48,
                    'decode.graph_replays': 199, 'decode.eager_steps': 1,
                    'batched.windows_real': 4, 'encoder.windows': 4,
                    'encoder.device_ms': 30.0}
    return rec


NEW = {
    'decode_dispatch_ms_per_step.transcribe': ((10 - 1) + (6 - 3)) / 2,
    'decode_sync_wait_ms_per_step.transcribe': (1 + 3) / 2,
    'decode_row_use.transcribe': 100 * 48 / 64,
    'decode_graph_share.transcribe': 100 * 199 / 200,
    'timing_host_ms_per_window.transcribe': (10 - 4) / 4,
    'encoder_device_ms_per_window.transcribe': 30 / 4,
    'read_host_ms_per_window.transcribe': (2 + 3 + 1) / 4,
    'assemble_host_ms_per_window.transcribe': (1 + 2 + 3 + 4) / 4,
}


@pytest.mark.parametrize('name', sorted(NEW))
def test_reader_by_hand(name):
    from perfbench.core.cell import Cell
    read = Cell.reader(name)
    assert read(SimpleNamespace(recording=_recording())) == pytest.approx(NEW[name])
    assert read(SimpleNamespace(recording=None)) is None
    assert read(SimpleNamespace(recording=Recording())) is None


def test_wrapper_roofline_reads_one_wrapper():
    ctx = SimpleNamespace(profile=dict(per_op={'median.median_filter': (1e-6, 4e-6, 3),
                                               'dtw.dtw_cost': (1e-6, 0.0, 1)}))
    assert readers.wrapper_roofline(ctx, 'median.median_filter') == pytest.approx(25.0)
    assert readers.wrapper_roofline(ctx, 'dtw.dtw_cost') is None       # no device time
    assert readers.wrapper_roofline(ctx, 'vocab_proj.vocab_proj') is None
    assert readers.wrapper_roofline(SimpleNamespace(profile=None), 'dtw.dtw_cost') is None


def test_readers_without_their_spans_or_counters():
    rec = _recording()
    rec.counters.pop('batched.windows_real')
    ctx = SimpleNamespace(recording=rec)
    for f in (readers.timing_host_ms_per_window,
              lambda c: readers.host_phases_ms_per_window(c, readers.READ_PHASES)):
        assert f(ctx) is None
    rec = _recording()
    rec.spans = [s for s in rec.spans if s.name != 'decode.sync_wait']
    assert readers.decode_sync_wait_ms_per_step(SimpleNamespace(recording=rec)) is None
    rec.counters.pop('encoder.device_ms')
    assert readers.encoder_device_ms_per_window(SimpleNamespace(recording=rec)) is None


# -- a whole traced run at a tiny size -----------------------------------------------------

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_traced_run_reports_the_program_metrics(name, monkeypatch, record_property):
    """Every per-layer metric of the cell but its kind's ``CARD_ONLY`` is
    reported, and those are absent (never 0); every wrapper of the cell's
    family's own rules was wrapped and called in the profiled requests
    (their counts go to the JUnit record as ``wrapper_calls``)."""
    from perfbench.core import engine
    from perfbench.tests.test_perfbench_faults import SEED, shrink
    cells, tracers = [], []

    class Kept(Tracer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            tracers.append(self)
    monkeypatch.setattr(engine, 'Tracer', Kept)

    def configure(cell):
        shrink(cell)
        cells.append(cell)
    out = run_cell(ROOT, name, SEED, 1.5, True, time.perf_counter(), device='cpu',
                   configure=configure, log=lambda m: None)
    assert out['correct'], out['compared']
    (cell,), (tracer,) = cells, tracers
    metrics = out['metrics']
    card_only = set(cell.kind.CARD_ONLY)
    listed = {m['name'] for m in cell.per_layer}
    assert listed - card_only <= set(metrics)
    assert not card_only & set(metrics)
    # the program's recorder's readers, where the cell lists them
    on_cpu = (set(NEW) & listed) - card_only
    if 'decode_graph_share.transcribe' in on_cpu:
        # the CPU is eager
        assert metrics['decode_graph_share.transcribe']['value'] == 0.0
    assert all(metrics[m]['value'] > 0 for m in on_cpu - {'decode_graph_share.transcribe'})
    assert tracer.rules is cell.rules and tracer.kernels is cell.kernels
    calls = collections.Counter(label for label, *_ in tracer.op_calls)
    record_property('wrapper_calls', json.dumps(calls))
    if out['attempted'] > 1:          # the profile starts at the second request
        assert 'breakdown' in out
        own = set(cell.rules) - set(roofline.RULES)
        assert all(calls[f'{mod}.{attr}'] > 0 for mod, attr in own), calls
