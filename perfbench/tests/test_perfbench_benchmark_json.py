"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import re
from pathlib import Path

import pytest

from perfbench.core.cell import _load_module

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
END_TO_END = {m['name'] for m in BENCH['end_to_end']}
CELLS = {w['name'] for w in BENCH['workloads']}


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['perfbench']
    assert BENCH['command'][:2] == ['python3', 'perfbench/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_check_fits_its_time():
    n = 24
    runs = 2 + 14 * n
    total = runs * (BENCH['run_seconds'] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize('entry', BENCH['configs'], ids=lambda c: c['name'])
def test_config(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(entry['name'])
    assert entry['source'].startswith('https://')
    path = ROOT / entry['file']
    assert path.is_file() and entry['file'].startswith('perfbench/')
    cfg = json.loads(path.read_text())
    assert cfg['name'] == entry['name'] and cfg['source'] == entry['source']
    assert cfg['reduced'] == entry['reduced']
    assert set(cfg['reduced']) <= set(cfg) and len(cfg['reduced']) <= 16
    assert all(NAME.match(k) for k in cfg['reduced'])
    assert (ROOT / cfg['reference']).is_file()
    assert cfg['dtype'] in ('float32', 'bfloat16', 'float16')
    assert isinstance(cfg['dims'], dict)
    assert NAME.match(cfg['family'])
    family = ROOT / 'perfbench' / 'families' / f"{cfg['family']}.py"
    _load_module(family, f"family_{cfg['family']}").check_config(cfg)


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    for key in ('name', 'config', 'traffic'):
        assert NAME.match(cell[key])
    assert cell['chips'] in (1, 4)
    assert 1 <= len(cell['why']) <= 200 and '\n' not in cell['why']
    assert cell['config'] in {c['name'] for c in BENCH['configs']}
    traffic = json.loads((ROOT / 'perfbench' / 'traffic'
                          / f"{cell['traffic']}.json").read_text())
    assert (ROOT / 'perfbench' / 'generators' / f"{traffic['kind']}.py").is_file()
    assert (ROOT / 'perfbench' / 'limits' / f"{cell['name']}.json").is_file()
    reported = {m['name'] for m in BENCH['end_to_end']
                if 'workloads' not in m or cell['name'] in m['workloads']}
    assert 'setup_s' in reported and len(reported) >= 2
    layers = [m for m in BENCH['per_layer'] if cell['name'] in m.get('workloads', [])]
    assert layers


@pytest.mark.parametrize('metric', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric(metric):
    allowed = {'name', 'unit', 'better', 'source', 'workloads'}
    if metric in BENCH['end_to_end']:
        allowed.add('bound')
        assert 0.01 <= metric['bound'] <= 0.25
        assert metric['source'] in ('host_clock', 'device_trace')
    else:
        allowed |= {'layer', 'moves'}
        assert metric['moves'] in END_TO_END
        assert 1 <= len(metric['layer']) <= 200
        for cell in metric['workloads']:
            mover = next(m for m in BENCH['end_to_end'] if m['name'] == metric['moves'])
            assert 'workloads' not in mover or cell in mover['workloads']
    assert set(metric) <= allowed
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('device_trace', 'program_span', 'program_counter',
                                'host_clock')
    assert set(metric.get('workloads', [])) <= CELLS
    assert (ROOT / 'perfbench' / 'metrics' / f"{metric['name']}.py").is_file()


def test_names_unique():
    for key in ('configs', 'workloads'):
        names = [x['name'] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(metrics) == len(set(metrics))
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


def test_layers_one_spelling():
    by_prefix = {}
    for m in BENCH['per_layer']:
        by_prefix.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in by_prefix.values())
