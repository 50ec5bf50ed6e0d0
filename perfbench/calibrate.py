"""Readings for a cell's limits: the program's compared numbers and the
control's, over many seeds, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [--first <seed>] [--also <seed> ...]

The control is the reference computed in the nearest precision below the
configuration's (float8 e4m3 weights with a scale per row, int4 keys and
values with a scale per position) put in the program's place, at each
position of the same inputs and served tokens; the f32 reference reads
both. Each seed is a fresh model and a short window at the cell's own
load. The control's numbers go through the cell's limits as the program's
do, and each line says whether the control came out correct (it has to
come out not correct). Prints one JSON line per seed and a summary;
writes nothing else.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--first', type=int, default=2_200_000_001)
    ap.add_argument('--also', type=int, nargs='*', default=[],
                    help='seeds to read besides the --seeds drawn ones')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench.core.engine import run_cell
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    rows = []
    seeds = [args.first + 7919 * k for k in range(args.seeds)] + list(args.also)
    for seed in seeds:
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       time.perf_counter(), device='cuda',
                       log=lambda m: print(m, file=sys.stderr, flush=True),
                       with_control=True)
        row = dict(seed=seed, program=out['readings'], correct=out['correct'],
                   control=out['control'], control_correct=out['control_correct'],
                   attempted=out['attempted'], failed=out['failed'])
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    names = sorted(k for k in rows[0]['program'] if k not in ('tokens',))
    summary = {n: dict(program_max=max(r['program'][n] for r in rows),
                       control_min=min(r['control'][n] for r in rows))
               for n in names}
    print(json.dumps(dict(summary=summary, seeds=len(rows),
                          program_correct=sum(r['correct'] for r in rows),
                          control_correct=sum(r['control_correct'] for r in rows))),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
