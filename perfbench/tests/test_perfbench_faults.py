"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card: ``correct`` is true as the program stands and false with
the timed path broken underneath, once for each fault the cell can have.
Inference cells have one: a token or an answer altered where it is
produced (the training and multi-chip faults do not apply). The cell's
traffic kind plants it (``FAULTS`` of ``perfbench/generators/<kind>.py``;
the long-form kind twice: a greedy step's token, and the no-speech
probability). The limits are the committed ones of each cell (long-form:
the widest distance of a log-probability the decode answered with, each
served token's and each window's no-speech, from the reference's)."""
import json
import time
from pathlib import Path

import pytest

from perfbench.core.cell import _load_module, find
from perfbench.core.engine import run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
SEED = 2**31 + 4099


def shrink(cell):
    """The family's tiny model, and the traffic kind's tiny mix."""
    cell.family.tiny(cell.config)
    cell.kind.tiny(cell.traffic)


def run(name, seconds=0.5):
    return run_cell(ROOT, name, SEED, seconds, False, time.perf_counter(),
                    device='cpu', configure=shrink, log=lambda m: None)


def kind(name):
    """The traffic kind's module of cell ``name``."""
    w = next(w for w in BENCH['workloads'] if w['name'] == name)
    k = json.loads(find('traffic', w['traffic'], '.json').read_text())['kind']
    return _load_module(find('generators', k), f'test_kind_{k}')


# a kind without its hooks fails its own test below, not the collection
CASES = [(w['name'], f) for w in BENCH['workloads']
         for f in getattr(kind(w['name']), 'FAULTS', ())]


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_kind_gives_its_test_hooks(name):
    mod = kind(name)
    assert callable(mod.tiny) and mod.FAULTS and all(map(callable, mod.FAULTS))
    per_layer = {m['name'] for m in BENCH['per_layer']}
    assert set(mod.CARD_ONLY) <= per_layer


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
