"""The port's in-memory recorder (``profiling.recording``) on the CPU.

Off, it changes nothing: the batched driver gives the same tokens and
segments, reads the clock only for ``batched.HOST_PHASES``, opens no
``record_function`` range and makes no extra host read. On, its spans nest
(each parent open around its children, one request id a request), the
decode loop's spans and counters agree with the calls the loop makes, the
host phases' spans sum to ``HOST_PHASES``, the padded and real windows
fill every group, and the benchmark's hooks on ``_greedy_loop``,
``select_from_aggregates`` and ``decode_collect`` still see every step.
Ranges appear only inside ``profile_trace``, never under a profiler
started elsewhere."""
import collections
import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

from stable_ts_tpu_torch import batched, profiling
from stable_ts_tpu_torch.models.whisper import decoding

torch.set_num_threads(2)
SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]
BATCH, SAMPLE_LEN = 2, 8
OPTIONS = dict(batch_size=BATCH, language='en', temperature=0,
               sample_len=SAMPLE_LEN, verbose=None)
HOST_PHASE_NAMES = {'host_load', 'host_silence_predict', 'host_window_stack',
                    'host_window_prep', 'host_upload_dispatch', 'host_segmentize',
                    'host_timing_launch', 'host_timing_finish',
                    'host_assemble_suppress', 'host_result_build', 'host_regroup'}


@pytest.fixture(scope='module')
def model():
    from stable_ts_tpu_torch import load_test_model
    return load_test_model(device='cpu', alignment_heads=HEADS)


@pytest.fixture(scope='module')
def audio():
    """75 s of a modulated tone: three windows, so groups of two end with
    one padded row."""
    rng = np.random.default_rng(0)
    t = np.arange(SR * 75) / SR
    tone = np.sin(2 * np.pi * 300 * t) * (0.3 + 0.2 * np.sin(2 * np.pi * 3 * t))
    return (tone + rng.standard_normal(len(t)) * 0.01).astype(np.float32)


def _record(model, audio):
    batched.HOST_PHASES.clear()
    with profiling.recording() as rec:
        result = model.transcribe_batched(audio, **OPTIONS)
    return rec, result, dict(batched.HOST_PHASES)


def _segments(result):
    return [(s.start, s.end, s.text, list(s.tokens)) for s in result.segments]


class _Counting:
    """Wraps ``owner.attr`` to count its calls."""

    def __init__(self, monkeypatch, owner, attr):
        self.n, fn = 0, getattr(owner, attr)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(owner, attr, counted)


def test_off_and_on_give_the_same_result(model, audio):
    assert profiling._recording is None
    off = model.transcribe_batched(audio, **OPTIONS)
    rec, on, _ = _record(model, audio)
    assert rec.spans and profiling._recording is None
    assert _segments(on) == _segments(off) and on.text == off.text
    assert on.to_srt_vtt(word_level=True) == off.to_srt_vtt(word_level=True)


def test_off_reads_no_clock_and_opens_no_range(model, audio, monkeypatch):
    """Off: the clock is read twice a host phase and nowhere else in the
    driver and the decode, no span or range is opened, nothing counted."""
    reads, ranges = [0], []
    clock = time.perf_counter_ns

    def counted_clock():
        reads[0] += 1
        return clock()
    hp = _Counting(monkeypatch, batched, '_hp')
    monkeypatch.setattr(time, 'perf_counter_ns', counted_clock)
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: ranges.append(name))
    monkeypatch.setattr(profiling.Recording, 'open', None)
    model.transcribe_batched(audio, **OPTIONS)
    assert hp.n > 0 and reads[0] == 2 * hp.n and ranges == []


def test_spans_nest_within_their_request(model, audio):
    rec, _, _ = _record(model, audio)
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    (request,) = rec.named('batched.request')
    assert request.parent == 0 and request.request > 0
    for s in rec.spans:
        assert s.request == request.request and s.thread == request.thread
        if s is not request:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert {s.name for s in rec.spans if s.parent == request.id} == {
        'batched.group', 'host_result_build', 'host_regroup'}
    for name in ('decode.step', 'decode.prefill', 'decode.collect', 'encoder',
                 'host_load', 'host_timing_finish'):
        assert {by_id[s.parent].name for s in rec.named(name)} <= {
            'batched.group', 'host_upload_dispatch'}
    assert {by_id[s.parent].name for s in rec.named('decode.sync_wait')} == {
        'decode.step'}
    # the self time of a span is its own less its children's
    step = rec.named('decode.step')[0]
    kids = [s for s in rec.spans if s.parent == step.id]
    assert [k.name for k in kids] == ['decode.sync_wait']
    assert rec.self_ns('decode.step') == (rec.total_ns('decode.step')
                                          - rec.total_ns('decode.sync_wait'))


def test_steps_match_the_loop(model, audio, monkeypatch):
    """A loop's ``decode.step`` spans are one more than its decoder steps;
    each but the last, ended by ``sample_len``, holds one sync wait."""
    steps = _Counting(monkeypatch, decoding, 'decoder_step')
    loops = _Counting(monkeypatch, decoding, '_greedy_loop')
    rec, result, _ = _record(model, audio)
    n_steps = len(rec.named('decode.step'))
    assert n_steps == rec.counters['decode.steps'] == steps.n + loops.n
    assert loops.n == len(rec.named('decode.prefill')) == 2
    # random weights decode to sample_len: no loop ends early
    assert n_steps == loops.n * SAMPLE_LEN
    assert len(rec.named('decode.sync_wait')) == n_steps - loops.n
    assert rec.counters['decode.row_steps'] == BATCH * n_steps
    windows = rec.counters['batched.windows_real']
    assert rec.counters['decode.tokens_kept'] == windows * SAMPLE_LEN
    assert rec.counters['encoder.windows'] == windows
    assert 'encoder.device_ms' not in rec.counters        # the CPU: host time only


@pytest.mark.parametrize('finish_at', [None, 0, 2, 4])
@pytest.mark.parametrize('on', [False, True])
def test_greedy_loop_reads_the_device_once_a_step(monkeypatch, on, finish_at):
    """The loop on stubs: every row reaches EOT at step ``finish_at``
    (None: never, sample_len 5 ends it). Host reads, spans and counters,
    with the recorder off and on. The flag is read one step late, so a
    loop that ends on EOT before sample_len queues one decoder step more
    than it keeps."""
    eot, sample_len, rows = 9, 5, 3
    calls = collections.Counter()
    real_bool = torch.Tensor.__bool__

    def counted_bool(t):
        calls['bool'] += 1
        return real_bool(t)

    def select(agg, with_grammar):
        calls['select'] += 1
        tok = eot if calls['select'] - 1 == finish_at else 1
        return torch.full((rows,), tok), torch.zeros(rows)

    def step(tokens, pos, return_hidden=True):
        calls['step'] += 1
        return torch.zeros(rows, 4)

    monkeypatch.setattr(decoding, 'logit_aggregates', lambda logits, ts: logits)
    monkeypatch.setattr(decoding, 'select_from_aggregates', select)
    monkeypatch.setattr(torch.Tensor, '__bool__', counted_bool)
    with (profiling.recording() if on else contextlib.nullcontext()) as rec:
        tokens, _ = decoding._greedy_loop(
            step, lambda logits, *a: logits, torch.zeros(rows, 4),
            lambda x, flags: x, sample_begin=3, sample_len=sample_len, eot=eot,
            ts_begin=100, with_grammar=True)
    monkeypatch.undo()
    n = sample_len if finish_at is None else finish_at + 1
    reads = n - 1 if n == sample_len else n
    assert tokens.shape == (rows, n)
    assert (calls['select'], calls['step'], calls['bool']) == (n, reads, reads)
    if on:
        assert len(rec.named('decode.step')) == rec.counters['decode.steps'] == n
        assert len(rec.named('decode.sync_wait')) == reads
        assert rec.counters['decode.row_steps'] == rows * n
        assert rec.counters.get('decode.steps_discarded', 0) == reads - (n - 1)


def _straight_greedy(select, step, epilogue, agg, *, rows, sample_begin,
                     sample_len, eot, ts_begin):
    """The greedy loop written plainly: each step's flag read before the
    next step is queued, the grammar flags from the token history."""
    finished = torch.zeros(rows, dtype=torch.bool)
    sum_logprobs = torch.zeros(rows, dtype=torch.float32)
    history = []
    for i in range(sample_len):
        tok, lp = select(agg, True)
        sum_logprobs += torch.where(finished, 0.0, lp)
        tok = torch.where(finished, eot, tok)
        history.append(tok)
        finished = finished | (tok == eot)
        if i + 1 == sample_len or bool(finished.all()):
            break
        flags = []
        for r in range(rows):
            seq = [int(t[r]) for t in history]
            stamps = [t - ts_begin for t in seq if t >= ts_begin]
            max_ts = max(stamps) if stamps else -1
            last_ts = seq[-1] >= ts_begin
            penult_ts = len(seq) < 2 or seq[-2] >= ts_begin
            text_ban, ts_ban = last_ts and not penult_ts, last_ts and penult_ts
            flags.append([int(text_ban), int(ts_ban), int(max_ts >= 0),
                          max_ts if text_ban else max_ts + 1])
        agg = epilogue(step(tok[:, None], sample_begin + i, return_hidden=True),
                       torch.tensor(flags, dtype=torch.int32))
    return torch.stack(history, dim=1), sum_logprobs


@pytest.mark.parametrize('finish', [(None, None, None), (0, 0, 0), (2, 2, 2),
                                    (4, 4, 4), (1, None, 3), (0, 3, 1)],
                         ids=['none', 'at0', 'at2', 'at4', 'mix_open', 'mix_at3'])
def test_greedy_loop_reads_the_stop_flag_one_step_late(monkeypatch, finish):
    """The loop on stubs whose tokens follow the step, the epilogue and
    the grammar flags, row r reaching EOT at its pick ``finish[r]`` (None:
    never; sample_len 5), against :func:`_straight_greedy`: the same
    tokens and sums bit for bit, the pick called once a kept step on the
    same aggregates in order, and one discarded step exactly when the
    loop ends on EOT before sample_len."""
    eot, ts_begin, sample_len, rows = 99, 100, 5, 3

    def stubs():
        seen = {'agg': [], 'steps': 0}

        def select(agg, with_grammar):
            k = len(seen['agg'])
            seen['agg'].append(agg)
            score = agg.sum(dim=1)
            tok = 90 + (score.abs() * 1000).long() % 31    # text and timestamps
            tok = torch.where(tok == eot, tok + 1, tok)
            tok = torch.where(torch.tensor([f == k for f in finish]), eot, tok)
            return tok, -score.abs() * 0.1

        def step(tokens, pos, return_hidden=True):
            seen['steps'] += 1
            return torch.sin(tokens.float() * 0.37 + pos * 1.3 + torch.arange(4.0)
                             + torch.arange(rows)[:, None] * 0.7)

        def epilogue(x, flags):
            return (torch.cat([x, flags[:, :2].float()], dim=1)
                    + flags[:, 2:3].float() * 0.5 + flags[:, 3:].float() * 0.01)
        return seen, select, step, epilogue

    agg0 = torch.linspace(-1.0, 1.0, rows * 6).reshape(rows, 6)
    ref_seen, select, step, epilogue = stubs()
    want_tok, want_sums = _straight_greedy(
        select, step, epilogue, agg0, rows=rows, sample_begin=3,
        sample_len=sample_len, eot=eot, ts_begin=ts_begin)
    seen, select, step, epilogue = stubs()
    monkeypatch.setattr(decoding, 'logit_aggregates', lambda logits, ts: logits)
    monkeypatch.setattr(decoding, 'select_from_aggregates', select)
    with profiling.recording() as rec:
        tokens, sums = decoding._greedy_loop(
            step, lambda logits, *a: logits, agg0, epilogue, sample_begin=3,
            sample_len=sample_len, eot=eot, ts_begin=ts_begin, with_grammar=True)
    n = want_tok.shape[1]
    early = None not in finish and max(finish) + 1 < sample_len
    assert n == (max(finish) + 1 if early else sample_len)
    if None in finish:      # the grammar flags took part
        assert (want_tok >= ts_begin).any() and (want_tok < eot).any()
    assert torch.equal(tokens, want_tok) and torch.equal(sums, want_sums)
    assert len(seen['agg']) == len(ref_seen['agg']) == n
    assert all(torch.equal(a, b) for a, b in zip(seen['agg'], ref_seen['agg']))
    assert rec.counters.get('decode.steps_discarded', 0) == int(early)
    assert seen['steps'] == ref_seen['steps'] + int(early) == n - 1 + int(early)
    assert rec.counters['decode.steps'] == n
    assert 'decode.overlapped_steps' not in rec.counters    # the CPU reads in place


def test_host_reads_equal_on_and_off(model, audio, monkeypatch):
    model.transcribe_batched(audio, **OPTIONS)      # tokenizers and caches
    counts = []
    for on in (False, True):
        reads = collections.Counter()
        for attr in ('__bool__', 'item', 'tolist', 'cpu'):
            real = getattr(torch.Tensor, attr)

            def counted(t, *a, _real=real, _attr=attr, **k):
                reads[_attr] += 1
                return _real(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, attr, counted)
        if on:
            _record(model, audio)
        else:
            model.transcribe_batched(audio, **OPTIONS)
        monkeypatch.undo()
        counts.append(reads)
    assert counts[0] == counts[1] and counts[0]['__bool__'] > 0


def test_host_phases_equal_their_spans(model, audio):
    rec, _, phases = _record(model, audio)
    assert set(phases) == HOST_PHASE_NAMES
    assert {s.name for s in rec.spans} & HOST_PHASE_NAMES == set(phases)
    for name, total in phases.items():
        summed = 0.0
        for s in rec.named(name):       # in the order the phases closed
            summed = summed + s.ns / 1e9
        assert summed == total


def test_padded_and_real_windows_fill_the_groups(model, audio):
    rec, _, _ = _record(model, audio)
    groups = [s.attrs for s in rec.named('batched.group') if s.attrs]
    assert [g['group'] for g in groups] == list(range(len(groups)))
    real, padded = (rec.counters['batched.windows_real'],
                    rec.counters['batched.windows_padded'])
    assert real + padded == len(groups) * BATCH
    assert (real, padded) == (sum(g['rows'] for g in groups),
                              sum(g['padded'] for g in groups)) == (3, 1)


def test_benchmark_hooks_see_every_step(model, audio):
    """The benchmark's recording of the served tokens patches the loop,
    the pick and the collection; it sees every step with the recorder on."""
    from perfbench.generators import longform
    wl = longform.Workload({}, {}, 0, 'cpu')
    wl.install(model)
    try:
        rec, result, _ = _record(model, audio)
    finally:
        wl.uninstall(model)
    assert len(wl._loops) == len(rec.named('decode.prefill')) == 2
    assert sum(map(len, wl._loops)) == len(rec.named('decode.step'))
    assert len(wl._calls) == len(rec.named('decode.collect')) == 2
    assert 'decode_collect' not in vars(model)
    assert decoding._greedy_loop.__name__ == '_greedy_loop'


def test_ranges_only_inside_profile_trace(model, audio, tmp_path):
    """profile_trace writes the spans as ranges; a profiler started
    elsewhere, with the recorder on, gets none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            model.transcribe_batched(audio, **OPTIONS)
    assert rec.named('decode.step')
    names = {e.name for e in prof.events()}
    assert not names & {'decode.step', 'batched.group', 'host_load'}
    with profiling.profile_trace(str(tmp_path)):
        assert profiling._recording is not None
        model.transcribe_batched(audio, **OPTIONS)
    assert profiling._recording is None
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith('.pt.trace.json')]
    with open(tmp_path / trace) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    assert {'batched.group', 'decode.step', 'decode.sync_wait', 'decode.prefill',
            'encoder'} | HOST_PHASE_NAMES <= names


class _FakeEvent:
    """A CUDA timing event whose device reaches it on the second query."""
    made = []

    def __init__(self, enable_timing=False):
        self.queries, self.t = 0, len(_FakeEvent.made) * 2.5
        _FakeEvent.made.append(self)

    def record(self):
        pass

    def query(self):
        self.queries += 1
        return self.queries > 1

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_times_are_read_after_the_device_passed_them(monkeypatch):
    """A span with ``device_time`` adds its events' elapsed time to
    ``<name>.device_ms`` only once the end event is done: reading never
    waits."""
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, 'Event', _FakeEvent)
    monkeypatch.setattr(torch.cuda, 'synchronize', None)
    with profiling.recording() as rec:
        with profiling.span('encoder', device_time=True):
            pass
        profiling.read_device_times()
        assert 'encoder.device_ms' not in rec.counters
        profiling.read_device_times()
        assert rec.counters['encoder.device_ms'] == 2.5
        with profiling.span('encoder', device_time=True):
            pass
    # the second pair was not done when the block ended: not counted
    assert rec.counters['encoder.device_ms'] == 2.5 and len(_FakeEvent.made) == 4


def test_a_span_left_open_is_dropped_with_its_parent():
    """A phase that an exception cut short (never closed) does not outlive
    the span around it, and later spans nest as before."""
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError):
            with profiling.span('outer'):
                profiling.open_at('host_load', time.perf_counter_ns())
                raise RuntimeError
        with profiling.span('next') as nxt:
            t0 = time.perf_counter_ns()
            profiling.open_at('host_load', t0)
            profiling.close_at('host_load', t0 + 5)
    assert [(s.name, s.parent) for s in rec.spans] == [
        ('outer', 0), ('host_load', nxt.id), ('next', 0)]
    assert rec.named('host_load')[0].ns == 5
