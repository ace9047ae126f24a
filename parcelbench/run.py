"""Run one benchmark cell once and print its result line.

    python3 parcelbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``xarray_parcel_tpu_torch``).  Exits non-zero, and prints no
result, without a CUDA card (or with fewer than the cell asks for), without
the program, or if JAX or the JAX package is loaded once the window has
closed.  The last lines of standard error are the compared numbers, each
with its limit; the last line of standard output is the result.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '.cache')


def process_start():
    """The process's start on ``time.time()``'s clock (from ``/proc``),
    else now."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith('btime'))
        return boot + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def main(argv=None):
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches at fixed paths inside the checkout.
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)

    import torch
    from parcelbench.harness import cells, runner

    cell = cells.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f'parcelbench: the cell needs {cell.chips} CUDA device(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    try:
        import xarray_parcel_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'parcelbench: the program is missing: {e}', file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    result, notes = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                               device, started)
    found = runner.forbidden_modules()
    if found:
        print(f'parcelbench: loaded in this process: {", ".join(found)}',
              file=sys.stderr)
        return 4
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
