"""Everything of a cell, found by name under the benchmark's folder."""
import importlib.util
import json
from pathlib import Path
from typing import Callable

from .. import roofline

HERE = Path(__file__).resolve().parents[1]          # perfbench/


def find(folder: str, name: str, suffix: str = '.py') -> Path:
    """The file of ``name`` in the benchmark's ``folder`` (``families``,
    ``generators``, ``traffic``, ``limits``, ``metrics``)."""
    return HERE / folder / f'{name}{suffix}'


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f'no module at {path}')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _joined(shared: dict, own: dict, what: str) -> dict:
    """``shared`` (``roofline.py``'s) with a family's ``own`` added; a key
    in both raises."""
    both = set(shared) & set(own)
    if both:
        raise KeyError(f'the family\'s {what} repeat roofline.py\'s: {sorted(both)}')
    return {**shared, **own}


class Cell:
    """A workload of BENCHMARK.json with its configuration, model family,
    traffic mix, traffic kind, metric readers and limits. A configuration
    that names no family, or one with no module, raises here, before any
    device work, as does a family rule or kernel list that ``roofline.py``
    already has a key for.

    ``rules`` and ``kernels``: ``roofline.RULES`` and ``roofline.KERNELS``
    joined with the family's own ``RULES`` and ``KERNELS`` (the ``ops/``
    wrappers only its model calls), which the traced run wraps and matches.
    """

    def __init__(self, bench: dict, workload: str, root: Path):
        cells = {w['name']: w for w in bench['workloads']}
        if workload not in cells:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
        self.entry = cells[workload]
        self.name = workload
        configs = {c['name']: c for c in bench['configs']}
        self.config = load_json(root / configs[self.entry['config']]['file'])
        family = self.config.get('family')
        if family is None:
            raise KeyError(f"configuration {self.entry['config']!r} names no "
                           f"family (perfbench/families/<family>.py)")
        self.family = _load_module(find('families', family),
                                   f'perfbench_family_{family}')
        self.family.check_config(self.config)
        self.rules = _joined(roofline.RULES, getattr(self.family, 'RULES', {}), 'RULES')
        self.kernels = _joined(roofline.KERNELS, getattr(self.family, 'KERNELS', {}),
                               'KERNELS')
        self.traffic = load_json(find('traffic', self.entry['traffic'], '.json'))
        self.kind = _load_module(find('generators', self.traffic['kind']),
                                 f"perfbench_kind_{self.traffic['kind']}")
        self.limits = load_json(find('limits', workload, '.json'))

        def applies(m):
            return 'workloads' not in m or workload in m['workloads']
        self.end_to_end = [m for m in bench['end_to_end'] if applies(m)]
        self.per_layer = [m for m in bench['per_layer'] if applies(m)]

    @staticmethod
    def reader(metric: str) -> Callable:
        mod = _load_module(find('metrics', metric),
                           'perfbench_metric_' + metric.replace('.', '_'))
        return mod.read
