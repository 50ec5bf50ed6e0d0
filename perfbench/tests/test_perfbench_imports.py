"""Nothing the benchmark loads is JAX or the JAX package; the reference
does not load the program either. Top-level module names are compared
whole: ``stable_ts_tpu_torch`` is not ``stable_ts_tpu``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / 'perfbench'
JAX_NAMES = {'jax', 'jaxlib', 'flax', 'stable_ts_tpu'}


def _top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split('.')[0])
    return names


SOURCES = sorted(p for p in PERFBENCH.rglob('*.py') if 'tests' not in p.parts)


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax_import_in_source(path):
    assert not _top_levels(path) & JAX_NAMES


@pytest.mark.parametrize('path', sorted((PERFBENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not _top_levels(path) & (JAX_NAMES | {'stable_ts_tpu_torch'})


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\n'
         'print(sorted({m.split(".")[0] for m in sys.modules}))'],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _loaded(
        'import sys; sys.path.insert(0, ".")\n'
        'from perfbench.core import engine, trace, weights, audio, ranks, cell\n'
        'from perfbench.reference import judge\n'
        'from perfbench.core.cell import Cell, load_json\n'
        'from pathlib import Path\n'
        'b = load_json(Path("BENCHMARK.json"))\n'
        'for w in b["workloads"]:\n'
        '    c = Cell(b, w["name"], Path("."))\n'
        '    [Cell.reader(m["name"]) for m in c.end_to_end + c.per_layer]\n'
        'import stable_ts_tpu_torch.loaders, stable_ts_tpu_torch.batched\n'
        'import stable_ts_tpu_torch.transcribe, stable_ts_tpu_torch.alignment\n')
    assert not loaded & JAX_NAMES
    assert 'stable_ts_tpu_torch' in loaded


def _family_configs() -> dict:
    """One configuration file of each family the benchmark's configurations name."""
    out = {}
    for path in sorted((PERFBENCH / 'configs').glob('*.json')):
        out.setdefault(json.loads(path.read_text())['family'], path)
    return out


@pytest.mark.parametrize('family,config', sorted(_family_configs().items()),
                         ids=lambda x: getattr(x, 'stem', x))
def test_family_loads_no_jax(family, config):
    """A family's module, its tiny model built on the CPU, its reference
    and its host phases load no JAX and no JAX package."""
    loaded = _loaded(
        'import sys; sys.path.insert(0, ".")\n'
        'import json\n'
        'from pathlib import Path\n'
        'import torch\n'
        'from perfbench.core.cell import _load_module\n'
        f'cfg = json.loads(Path({str(config)!r}).read_text())\n'
        f'family = _load_module(Path("perfbench/families/{family}.py"), "family")\n'
        'family.tiny(cfg)\n'
        'family.build(cfg, 1, torch.float32, "cpu")\n'
        'family.judge(cfg, 1, torch.float32, "cpu")\n'
        'family.judge(cfg, 1, torch.float32, "cpu", control=True)\n'
        'family.host_phases()\n')
    assert not loaded & JAX_NAMES


def test_reference_loads_no_program():
    loaded = _loaded('import sys; sys.path.insert(0, ".")\n'
                     'from perfbench.reference import judge, rules, whisper\n')
    assert not loaded & (JAX_NAMES | {'stable_ts_tpu_torch'})


def test_forbidden_compares_whole_names():
    from perfbench.core.engine import forbidden_modules
    assert forbidden_modules(['stable_ts_tpu_torch', 'stable_ts_tpu_torch.loaders',
                              'numpy', 'jaxtyping']) == []
    assert forbidden_modules(['stable_ts_tpu.models', 'jaxlib.xla_client',
                              'flax']) == ['flax', 'jaxlib', 'stable_ts_tpu']
