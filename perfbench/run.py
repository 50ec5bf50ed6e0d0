"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``stable_ts_tpu_torch``. Needs
as many CUDA devices as the cell asks for; exits 2 without a result when
they are not there, and 3 when JAX or the JAX package was loaded. The
last line of standard output is the result's JSON object; the compared
numbers and their limits are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / '.perfbench_cache' / 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          str(ROOT / '.perfbench_cache' / 'torch_extensions'))
    import torch
    from perfbench.core.engine import forbidden_modules, run_cell

    with open(ROOT / 'BENCHMARK.json') as f:
        bench = json.load(f)
    chips = {w['name']: w['chips'] for w in bench['workloads']}.get(args.workload)
    if chips is None:
        log(f'no workload {args.workload!r} in BENCHMARK.json')
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f'the cell needs {chips} CUDA device(s); torch.cuda.is_available() '
            f'is {torch.cuda.is_available()}, device_count '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        log(f'[device] {smi[0] if smi else "nvidia-smi gave nothing"}; '
            f'torch {torch.__version__}, cuda {torch.version.cuda}')
    except (OSError, subprocess.SubprocessError) as exc:
        log(f'[device] nvidia-smi unavailable: {exc}')

    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START, device='cuda', log=log)
    bad = forbidden_modules()
    if bad:
        log(f'forbidden modules loaded in this process: {bad}')
        return 3
    for name, c in out['compared'].items():
        log(f'compared {name} {float(c["value"])!r} limit {c["limit"]!r}')
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
