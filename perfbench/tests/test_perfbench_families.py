"""The model-family seam (``perfbench/families/<family>.py``).

A family that is not Whisper runs a whole cell on the CPU through
``run_cell``: a stub family (a plain-torch frame classifier that smooths
its frames with the port's median filter, judged by its own f64
reference), its own roofline rule for that filter, a stub traffic kind
with its test hooks, and a metric of the rule's share. Written to a
temporary folder, they are found by name through the harness's lookup;
added as new files and entries to a copy of the checkout, the
benchmark's own tests take the stub cell with no existing file edited.
The Whisper family serves the tokens and gives the compared numbers of
the model and judge built by hand as the harness built them before the
seam, and its cells wrap and match ``roofline.py``'s rules alone. A
configuration that names no family, or an unknown one, raises before the
CUDA context is made and before any weights are drawn.
"""
import json
import os
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest
import torch

from perfbench import roofline
from perfbench.core import cell as cell_mod
from perfbench.core import weights
from perfbench.core.engine import run_cell
from perfbench.tests.test_perfbench_faults import SEED, shrink

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())

STUB_FAMILY = '''
"""A frame classifier: 20-ms frames of samples, a GELU layer, a median
filter along the frames (the port's ``ops.median.median_filter``, looked
up on its module at each call), log-softmax over a small vocabulary;
judged by its plain reference (``reference/framenet.py``) in f64, the
control in bf16. Its own roofline rule covers the median filter, which
``roofline.py`` leaves out."""
import time
from pathlib import Path

import torch

from perfbench import roofline
from perfbench.core.cell import _load_module
from stable_ts_tpu_torch.ops import median

reference = _load_module(Path(__file__).resolve().parents[1] / 'reference' / 'framenet.py',
                         'perfbench_reference_framenet')


def median_filter(x, filter_width=7):
    """Each input and output byte once; a comparison an entry of each window."""
    return 2 * x.numel() * x.element_size(), x.numel() * filter_width, roofline.PEAK_F32


RULES = {('median', 'median_filter'): median_filter}
KERNELS = {('median', 'median_filter'): ('bitonicSortKVInPlace',)}


def _weights(dims, seed, dtype, device):
    f, d, v = dims['frame'], dims['d'], dims['vocab']
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(f * d + d * v, generator=gen, dtype=dtype, device=device)
    return flat[:f * d].view(f, d) * f ** -0.5, flat[f * d:].view(d, v) * d ** -0.5


class Model:
    def __init__(self, w1, w2, width):
        self.w1, self.w2, self.width = w1, w2, width

    def __call__(self, pcm):
        return self.forward(pcm)

    def forward(self, pcm):
        frame = self.w1.shape[0]
        x = pcm[:len(pcm) // frame * frame].view(-1, frame).to(self.w1)
        h = median.median_filter(torch.nn.functional.gelu(x @ self.w1).T, self.width).T
        return torch.log_softmax((h @ self.w2).double(), -1)


def build(cfg, seed, dtype, device):
    model = Model(*_weights(cfg['dims'], seed, dtype, device), cfg['dims']['width'])
    return model, [('drawn', time.perf_counter())]


def judge(cfg, seed, dtype, device, control=False):
    w1, w2 = _weights(cfg['dims'], seed, dtype, device)
    low = torch.bfloat16 if control else torch.float64
    return reference.Judge(reference.Model(w1.to(low), w2.to(low), cfg['dims']['width']))


def host_phases():
    return {}


def tiny(cfg):
    pass


def check_config(cfg):
    if set(cfg['dims']) != {'frame', 'd', 'vocab', 'width'}:
        raise ValueError(f"dims {sorted(cfg['dims'])}")
'''

STUB_REFERENCE = '''
"""The frame classifier's plain reference, in the precision of the
weights it is given."""
import torch
import torch.nn.functional as F


def median_filter(x, width):
    """The median of each window of ``width`` along the last axis, the ends
    reflected; ``x`` itself where it is no longer than half the width."""
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    padded = F.pad(x[None], (pad, pad), mode='reflect')[0]
    return padded.unfold(-1, width, 1).median(-1).values


class Model:
    def __init__(self, w1, w2, width):
        self.w1, self.w2, self.width = w1, w2, width

    def __call__(self, pcm):
        frame = self.w1.shape[0]
        x = pcm[:len(pcm) // frame * frame].view(-1, frame).to(self.w1)
        h = median_filter(F.gelu(x @ self.w1).T, self.width).T
        return torch.log_softmax((h @ self.w2).double(), -1)


class Judge:
    def __init__(self, model):
        self.model = model

    def gaps(self, items):
        return dict(logprob_gap=max(
            float((it['logprobs'] - self.model(it['pcm'].double())).abs().max())
            for it in items))

    def outputs(self, items):
        return [dict(it, logprobs=self.model(it['pcm'])) for it in items]
'''

STUB_KIND = '''
"""Short clips through the frame classifier, every output kept."""
import numpy as np
import torch

from perfbench.core.workload import Workload as Base

CARD_ONLY = ('median_roofline.stub',)


def tiny(params):
    params['seconds'] = [s / 10 for s in params['seconds']]


def shift_medians(monkeypatch):
    """Each median filter's output moved one frame on where it is made."""
    from stable_ts_tpu_torch.ops import median
    orig = median.median_filter
    monkeypatch.setattr(median, 'median_filter',
                        lambda x, filter_width=7: orig(x, filter_width).roll(1, dims=-1))


FAULTS = (shift_medians,)


class Workload(Base):
    kind = 'frames'

    def sizes(self):
        return [dict(seconds=s) for s in self.params['seconds']]

    def warmup(self, model):
        model(torch.zeros(int(16000 * self.params['seconds'][0])))

    def serve(self, model, req):
        pcm = torch.from_numpy(req['speech'].pcm.astype(np.float32) / 32768.0)
        return dict(index=req['index'], audio_s=req['audio_s'], pcm=pcm,
                    logprobs=model(pcm))

    def sample(self):
        k = min(self.params['check_items'], len(self.served))
        picked = self.rng('check').choice(len(self.served), k, replace=False)
        return [self.served[i] for i in sorted(picked)]

    def check(self, judge, items):
        return judge.gaps(items)

    def control(self, control_judge, items):
        return control_judge.outputs(items)
'''


def _reader(call: str) -> str:
    return f'''"""The stub cell's {call}."""
from perfbench.core import readers


def read(ctx):
    return readers.{call}
'''


STUB_CONFIG = dict(name='stub', source='https://example.com/stub-frame-classifier',
                   family='framenet', dtype='float32',
                   dims=dict(frame=320, d=48, vocab=32, width=5), reduced=[],
                   reference='perfbench/reference/framenet.py')

# the stub cell's files under perfbench/, its configuration left out
STUB_FILES = {
    'families/framenet.py': STUB_FAMILY,
    'reference/framenet.py': STUB_REFERENCE,
    'generators/frames.py': STUB_KIND,
    'traffic/frames.json': json.dumps(dict(kind='frames', seconds=[5.0, 3.0, 4.0],
                                           check_items=2)),
    # f64 reference against the program's f32: rounding reads ~4e-8 (four
    # seeds); the bf16 control 3.6e-4-5.1e-4, the fault far more
    'limits/stub.frames.json': json.dumps(dict(logprob_gap=dict(limit=1e-4))),
    'metrics/stub_audio_s_per_s.py': _reader('audio_rate(ctx)'),
    'metrics/median_roofline.stub.py': _reader(
        "wrapper_roofline(ctx, 'median.median_filter')"),
}

# and its entries in BENCHMARK.json
STUB_ENTRIES = dict(
    configs=[dict(name='stub', source=STUB_CONFIG['source'],
                  file='perfbench/configs/stub.json', reduced=[],
                  why='a second family: a frame classifier, a roofline rule of its own')],
    workloads=[dict(name='stub.frames', config='stub', traffic='frames', chips=1,
                    why='short clips, every frame judged: the family, its rule, its kind')],
    end_to_end=[dict(name='stub_audio_s_per_s', unit='audio_s/s', better='higher',
                     bound=0.25, source='host_clock', workloads=['stub.frames'])],
    per_layer=[dict(name='median_roofline.stub', unit='%', better='higher',
                    source='device_trace', layer='kernels (ops/ and csrc/)',
                    moves='stub_audio_s_per_s', workloads=['stub.frames'])])


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _bench(root: Path, config: dict, workload: str, traffic: str) -> None:
    """A BENCHMARK.json in ``root`` with one cell of ``config`` (written
    under ``root``) and the real harness's two end-to-end metrics."""
    _write(root / 'perfbench' / 'configs' / 'stub.json', json.dumps(config))
    metrics = [m for m in BENCH['end_to_end']
               if m['name'] in ('setup_s', 'transcribe_audio_s_per_s')]
    _write(root / 'BENCHMARK.json', json.dumps(dict(
        configs=[dict(name='stub', file='perfbench/configs/stub.json')],
        workloads=[dict(name=workload, config='stub', traffic=traffic, chips=1)],
        end_to_end=[{k: v for k, v in m.items() if k != 'workloads'} for m in metrics],
        per_layer=[])))


@pytest.fixture
def stub_root(tmp_path, monkeypatch):
    """A checkout root holding the stub cell's files and a BENCHMARK.json
    of that cell alone; the harness's lookup finds a name there first."""
    pb = tmp_path / 'perfbench'
    for rel, text in STUB_FILES.items():
        _write(pb / rel, text)
    _bench(tmp_path, STUB_CONFIG, 'stub.frames', 'frames')
    find = cell_mod.find

    def find_stub_first(folder, name, suffix='.py'):
        mine = pb / folder / f'{name}{suffix}'
        return mine if mine.exists() else find(folder, name, suffix)
    monkeypatch.setattr(cell_mod, 'find', find_stub_first)
    return tmp_path


def _run_stub(root, configure=None, with_control=False):
    def tiny(cell):
        shrink(cell)
        if configure is not None:
            configure(cell)
    return run_cell(root, 'stub.frames', SEED, 0.2, False, time.perf_counter(),
                    device='cpu', configure=tiny, log=lambda m: None,
                    with_control=with_control)


def test_stub_family_runs_a_cell(stub_root):
    out = _run_stub(stub_root, with_control=True)
    assert out['attempted'] > 0 and out['failed'] == 0
    assert out['correct'], out['compared']
    assert set(out['metrics']) == {'setup_s', 'transcribe_audio_s_per_s'}
    assert not out['control_correct'], out['control_compared']
    for part in ('core', 'generators', 'families'):
        assert not (ROOT / 'perfbench' / part / 'frames.py').exists()
        assert not (ROOT / 'perfbench' / part / 'framenet.py').exists()


def test_stub_family_fault_is_caught(stub_root):
    """Each answer altered where the model produces it."""
    def plant(cell):
        build = cell.family.build

        def broken(*args, **kwargs):
            model, marks = build(*args, **kwargs)
            forward = model.forward
            model.forward = lambda pcm: forward(pcm).roll(1, dims=-1)
            return model, marks
        cell.family.build = broken
    out = _run_stub(stub_root, configure=plant)
    assert out['attempted'] > 0 and out['failed'] == 0
    assert not out['correct'], out['compared']


@pytest.mark.parametrize('family', [None, 'nosuch'])
def test_config_without_a_known_family_raises_first(family, tmp_path, monkeypatch):
    """Raised before the CUDA context (the run asks for ``cuda``, which
    this CPU build would refuse with another error) and before a weight
    is drawn."""
    def drawn(*args, **kwargs):
        raise AssertionError('weights drawn')
    monkeypatch.setattr(weights, 'state_dict', drawn)
    cfg = json.loads((ROOT / 'perfbench' / 'configs' / 'large-v3.json').read_text())
    cfg.pop('family')
    if family:
        cfg['family'] = family
    _bench(tmp_path, cfg, 'stub.longform', 'longform')
    with pytest.raises(KeyError if family is None else FileNotFoundError,
                       match='family' if family is None else 'nosuch'):
        run_cell(tmp_path, 'stub.longform', SEED, 0.2, False, time.perf_counter(),
                 device='cuda', log=lambda m: None)


def _by_hand(name, n_requests):
    """The cell's model and judge built as the harness built them before
    the family seam, serving ``n_requests`` requests of the cell's tiny mix:
    (the served records, the compared numbers)."""
    from perfbench.core.ranks import rank_table
    from perfbench.reference.judge import Judge
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions
    from stable_ts_tpu_torch.models.whisper.load import convert_openai_state_dict

    cell = cell_mod.Cell(BENCH, name, ROOT)
    shrink(cell)
    cfg, dims = cell.config, cell.config['dims']
    dtype = getattr(torch, cfg['dtype'])
    heads = [(0, 1), (1, 0), (1, 1)]           # the tiny mask [[0, 1], [1, 1]]
    params = convert_openai_state_dict(weights.state_dict(dims, SEED, dtype, 'cpu'),
                                       ModelDimensions(**dims), dtype=dtype, device='cpu')
    model = WhisperTorch(ModelDimensions(**dims), params, device='cpu',
                         name=cfg['name'], ranks=rank_table(), alignment_heads=heads)
    wl = cell.kind.Workload(cell.traffic, dims, SEED, 'cpu')
    wl.warmup(model)
    wl.install(model)
    for i in range(n_requests):
        wl.served.append(wl.serve(model, wl.make_request(i)))
    wl.uninstall(model)
    items = wl.sample()
    judge = Judge(weights.state_dict(dims, SEED, dtype, 'cpu'), dims, rank_table(), 'cpu')
    return wl.served, wl.check(judge, items)


def _family(workload: dict) -> str:
    entry = next(c for c in BENCH['configs'] if c['name'] == workload['config'])
    return json.loads((ROOT / entry['file']).read_text())['family']


WHISPER_CELLS = [w['name'] for w in BENCH['workloads'] if _family(w) == 'whisper']


@pytest.mark.parametrize('name', WHISPER_CELLS)
def test_whisper_family_matches_the_hand_built_model(name):
    kept = []

    def configure(cell):
        shrink(cell)
        base = cell.kind.Workload

        class Kept(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                kept.append(self)
        cell.kind.Workload = Kept
    out = run_cell(ROOT, name, SEED, 0.5, False, time.perf_counter(), device='cpu',
                   configure=configure, log=lambda m: None)
    assert out['correct'], out['compared']
    (wl,) = kept
    served, numbers = _by_hand(name, len(wl.served))
    assert [r['tokens'] for r in wl.served] == [r['tokens'] for r in served]
    assert [r['scores'] for r in wl.served] == [r['scores'] for r in served]
    assert {k: c['value'] for k, c in out['compared'].items()} == {
        k: numbers[k] for k in out['compared']}


@pytest.mark.parametrize('name', WHISPER_CELLS)
def test_whisper_cells_wrap_the_roofline_rules_alone(name):
    cell = cell_mod.Cell(BENCH, name, ROOT)
    assert cell.rules == roofline.RULES and cell.kernels == roofline.KERNELS


@pytest.mark.parametrize('table', ['RULES', 'KERNELS'])
def test_family_repeating_a_roofline_wrapper_raises(table, stub_root):
    family = stub_root / 'perfbench' / 'families' / 'framenet.py'
    family.write_text(family.read_text() + f"\n{table}[('dtw', 'dtw_cost')] = "
                      f"{table}[('median', 'median_filter')]\n")
    bench = json.loads((stub_root / 'BENCHMARK.json').read_text())
    with pytest.raises(KeyError, match='dtw'):
        cell_mod.Cell(bench, 'stub.frames', stub_root)


def _files(folder: Path) -> dict:
    """Every file under ``folder`` but caches, by its path inside it."""
    return {p.relative_to(folder).as_posix(): p.read_bytes()
            for p in sorted(folder.rglob('*')) if p.is_file()
            and not {'__pycache__', '.pytest_cache'} & set(p.relative_to(folder).parts)}


# the benchmark's tests that take the stub cell up by its names
STUB_TESTS = {
    'test_config[stub]', 'test_cell[stub.frames]', 'test_metric[stub_audio_s_per_s]',
    'test_metric[median_roofline.stub]', 'test_kind_gives_its_test_hooks[stub.frames]',
    'test_sound_run_is_correct[stub.frames]',
    'test_fault_is_caught[stub.frames-shift_medians]',
    'test_traced_run_reports_the_program_metrics[stub.frames]',
    'test_family_loads_no_jax[framenet-stub]',
}


def test_a_second_family_lands_as_added_files(tmp_path, monkeypatch):
    """A copy of the checkout's benchmark with the stub cell added as new
    files and new entries of BENCHMARK.json only: the benchmark's own tests
    that name the stub cell pass there (the in-process stub tests above,
    which check that their files stay out of the checkout, are left out),
    the traced run wraps and calls the stub's median rule, the copy differs
    from the checkout by the added files and entries alone, and a Whisper
    cell of the copy wraps no median rule."""
    tree = tmp_path / 'tree'
    shutil.copytree(ROOT / 'perfbench', tree / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__', '.pytest_cache'))
    added = dict(STUB_FILES, **{'configs/stub.json': json.dumps(STUB_CONFIG)})
    for rel, text in added.items():
        with open(tree / 'perfbench' / rel, 'x') as f:     # never a file of the checkout
            f.write(text)
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for key, entries in STUB_ENTRIES.items():
        bench[key] = bench[key] + entries
    (tree / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))

    junit = tmp_path / 'junit.xml'
    env = {k: v for k, v in os.environ.items() if not k.startswith('PYTEST_')}
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [str(ROOT), env.get('PYTHONPATH')]))
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', str(tree / 'perfbench' / 'tests'), '-q',
         '-p', 'no:cacheprovider', '-p', 'no:randomly', '-k', 'stub and not stub_family',
         f'--junitxml={junit}', '-o', 'junit_family=xunit1'],   # xunit1 keeps properties
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-3000:]
    cases = {c.get('name'): c for c in ET.parse(junit).iter('testcase')}
    passed = {n for n, c in cases.items()
              if not any(e.tag in ('failure', 'error', 'skipped') for e in c)}
    assert STUB_TESTS <= passed, sorted(cases)
    traced = cases['test_traced_run_reports_the_program_metrics[stub.frames]']
    calls = json.loads(next(p.get('value') for p in traced.iter('property')
                            if p.get('name') == 'wrapper_calls'))
    assert calls.get('median.median_filter', 0) > 0, calls

    checkout, copy = _files(ROOT / 'perfbench'), _files(tree / 'perfbench')
    assert set(checkout) <= set(copy) and set(copy) - set(checkout) == set(added)
    assert {k: copy[k] for k in checkout} == checkout
    bench = json.loads((tree / 'BENCHMARK.json').read_text())
    assert {k: v[:len(BENCH[k])] if k in STUB_ENTRIES else v
            for k, v in bench.items()} == BENCH
    assert {k: bench[k][len(BENCH[k]):] for k in STUB_ENTRIES} == STUB_ENTRIES

    monkeypatch.setattr(cell_mod, 'HERE', tree / 'perfbench')
    stub = cell_mod.Cell(bench, 'stub.frames', tree)
    assert stub.rules == {**roofline.RULES, **stub.family.RULES}
    median = ('median', 'median_filter')
    assert median in stub.rules and median in stub.kernels
    for name in WHISPER_CELLS:
        cell = cell_mod.Cell(bench, name, tree)
        assert cell.rules == roofline.RULES and cell.kernels == roofline.KERNELS
        assert median not in cell.rules
