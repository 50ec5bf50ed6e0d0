"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card: ``correct`` is true as the program stands and false with
the timed path broken underneath, once for each fault the cell can have.
Inference cells have one: a token or an answer altered where it is
produced (the training and multi-chip faults do not apply), planted here
twice in the long-form cells: a greedy step's token, and the no-speech
probability. The limits are the committed ones of each cell: the widest
distance of a log-probability the decode answered with (each served
token's and each window's no-speech) from the reference's."""
import json
import time
from pathlib import Path

import pytest

from perfbench.core.engine import run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
SEED = 2**31 + 4099


def shrink(cell):
    """The family's tiny model, and the traffic kind's tiny mix."""
    cell.family.tiny(cell.config)
    t = cell.traffic
    if t['kind'] == 'longform':
        t.update(minutes=[1.2, 0.7], sample_len=[8, 10], batch_size=2,
                 warmup_sample_len=3, check_windows=3)


def run(name, seconds=0.5):
    return run_cell(ROOT, name, SEED, seconds, False, time.perf_counter(),
                    device='cpu', configure=shrink, log=lambda m: None)


def kind(name):
    w = next(w for w in BENCH['workloads'] if w['name'] == name)
    return json.loads((ROOT / 'perfbench' / 'traffic'
                       / f"{w['traffic']}.json").read_text())['kind']


def break_tokens(monkeypatch):
    """Every third greedy pick moved to the id below."""
    from stable_ts_tpu_torch.models.whisper import decoding
    orig = decoding.select_from_aggregates
    calls = [0]

    def altered(agg, with_grammar=True):
        tok, lp = orig(agg, with_grammar)
        calls[0] += 1
        return ((tok - 1).clamp(min=0) if calls[0] % 3 == 0 else tok), lp
    monkeypatch.setattr(decoding, 'select_from_aggregates', altered)


def break_no_speech(monkeypatch):
    """Each window's no-speech probability, an answer of the decode, scaled
    tenfold where the results are built."""
    from stable_ts_tpu_torch import loaders
    orig = loaders._decode_collect

    def altered(pending, with_features=True):
        results = orig(pending, with_features=with_features)
        for r in results:
            r.no_speech_prob *= 10.0
        return results
    monkeypatch.setattr(loaders, '_decode_collect', altered)


FAULTS = {'longform': [break_tokens, break_no_speech]}
CASES = [(w['name'], f) for w in BENCH['workloads'] for f in FAULTS[kind(w['name'])]]


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_sound_run_is_correct(name):
    out = run(name)
    assert out['attempted'] > 0 and out['failed'] == 0
    assert out['correct'], out['compared']
    assert set(out['compared']) == set(json.loads(
        (ROOT / 'perfbench' / 'limits' / f'{name}.json').read_text()))


@pytest.mark.parametrize('name,fault', CASES, ids=lambda x: getattr(x, '__name__', x))
def test_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(name)
    assert not out['correct'], out['compared']
