"""The model-family seam (``perfbench/families/<family>.py``).

A family that is not Whisper runs a whole cell on the CPU through
``run_cell``: a stub family (a plain-torch frame classifier judged by its
own f64 reference) and a stub traffic kind, written to a temporary folder
and found by name through the harness's lookup, with no file of the
benchmark edited. The Whisper family serves the tokens and gives the
compared numbers of the model and judge built by hand as the harness
built them before the seam. A configuration that names no family, or an
unknown one, raises before the CUDA context is made and before any
weights are drawn.
"""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench.core import cell as cell_mod
from perfbench.core import weights
from perfbench.core.engine import run_cell
from perfbench.tests.test_perfbench_faults import SEED, shrink

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())

STUB_FAMILY = '''
"""A frame classifier: 20-ms frames of samples, a GELU layer, log-softmax
over a small vocabulary; judged by its f64 reference."""
import time

import torch


def _weights(dims, seed, dtype, device):
    f, d, v = dims['frame'], dims['d'], dims['vocab']
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(f * d + d * v, generator=gen, dtype=dtype, device=device)
    return flat[:f * d].view(f, d) * f ** -0.5, flat[f * d:].view(d, v) * d ** -0.5


class Model:
    def __init__(self, w1, w2):
        self.w1, self.w2 = w1, w2

    def __call__(self, pcm):
        return self.forward(pcm)

    def forward(self, pcm):
        frame = self.w1.shape[0]
        x = pcm[:len(pcm) // frame * frame].view(-1, frame).to(self.w1)
        logits = torch.nn.functional.gelu(x @ self.w1) @ self.w2
        return torch.log_softmax(logits.double(), -1)


class Judge:
    def __init__(self, model):
        self.model = model

    def gaps(self, items):
        return dict(logprob_gap=max(
            float((it['logprobs'] - self.model(it['pcm'].double())).abs().max())
            for it in items))

    def outputs(self, items):
        return [dict(it, logprobs=self.model(it['pcm'])) for it in items]


def build(cfg, seed, dtype, device):
    model = Model(*_weights(cfg['dims'], seed, dtype, device))
    return model, [('drawn', time.perf_counter())]


def judge(cfg, seed, dtype, device, control=False):
    w1, w2 = _weights(cfg['dims'], seed, dtype, device)
    low = torch.bfloat16 if control else torch.float64
    return Judge(Model(w1.to(low), w2.to(low)))


def host_phases():
    return {}


def tiny(cfg):
    pass


def check_config(cfg):
    if set(cfg['dims']) != {'frame', 'd', 'vocab'}:
        raise ValueError(f"dims {sorted(cfg['dims'])}")
'''

STUB_KIND = '''
"""Short clips through the frame classifier, every output kept."""
import numpy as np
import torch

from perfbench.core.workload import Workload as Base


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
    """A checkout root holding the stub's configuration, family, kind, mix
    and limits; the harness's lookup finds a name there first."""
    pb = tmp_path / 'perfbench'
    _write(pb / 'families' / 'framenet.py', STUB_FAMILY)
    _write(pb / 'generators' / 'frames.py', STUB_KIND)
    _write(pb / 'traffic' / 'frames.json',
           json.dumps(dict(kind='frames', seconds=[0.5, 0.3, 0.4], check_items=2)))
    # f64 reference against the program's f32: rounding reads ~1e-6; the
    # bf16 control reads ~7e-4, the fault far more
    _write(pb / 'limits' / 'stub.frames.json',
           json.dumps(dict(logprob_gap=dict(limit=1e-4))))
    _bench(tmp_path, dict(name='stub', family='framenet', dtype='float32',
                          dims=dict(frame=320, d=48, vocab=32), reduced=[]),
           'stub.frames', 'frames')
    find = cell_mod.find

    def find_stub_first(folder, name, suffix='.py'):
        mine = pb / folder / f'{name}{suffix}'
        return mine if mine.exists() else find(folder, name, suffix)
    monkeypatch.setattr(cell_mod, 'find', find_stub_first)
    return tmp_path


def _run_stub(root, configure=None, with_control=False):
    return run_cell(root, 'stub.frames', SEED, 0.2, False, time.perf_counter(),
                    device='cpu', configure=configure, log=lambda m: None,
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


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
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
