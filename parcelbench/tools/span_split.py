"""A cell's traced calls split by the program's ``xparcel.*`` spans.

    python3 parcelbench/tools/span_split.py --workload <cell> --seed <n>

Makes the cell's inputs from the seed, warms each time step once, traces
the cell's ``trace_calls`` calls as a ``--trace 1`` run does, and prints,
per call, for each span name and for each layer (``xparcel.<layer>.*``):
how often it runs, its host time, the kernel launches (``cudaLaunchKernel*``
calls) that start inside it and the card's idle time under it, nested
spans of one name counted once.  Needs a CUDA card; the benchmark's runs
never run it.
"""

import argparse
import bisect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def union(intervals):
    """Sorted disjoint [start, end] intervals covering ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def overlap(xs, ys):
    """Total length shared by two lists of sorted disjoint intervals."""
    total, i = 0.0, 0
    for a, b in xs:
        while i < len(ys) and ys[i][1] <= a:
            i += 1
        j = i
        while j < len(ys) and ys[j][0] < b:
            total += min(b, ys[j][1]) - max(a, ys[j][0])
            j += 1
    return total


def split(trace, calls):
    """Rows (name, spans, host ms, launches, idle ms), each per call."""
    lo, hi = trace.window
    gaps = trace.gaps()
    launches = sorted(a for a, _, name in trace.host
                      if name.startswith('cudaLaunchKernel')
                      and lo <= a <= hi)
    groups = {}
    for a, b, name in trace.host:
        if name.startswith('xparcel.') and a >= lo and b <= hi:
            for key in (name, '.'.join(name.split('.')[:2]) + '.*'):
                groups.setdefault(key, []).append((a, b))
    rows = []
    for name in sorted(groups):
        spans = union(groups[name])
        starts = [a for a, _ in spans]
        inside = sum(1 for t in launches
                     if (i := bisect.bisect_right(starts, t) - 1) >= 0
                     and t < spans[i][1])
        rows.append((name, len(groups[name]) / calls,
                     1e-3 * sum(b - a for a, b in spans) / calls,
                     inside / calls, 1e-3 * overlap(gaps, spans) / calls))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from parcelbench.harness import card, cells, runner

    cell = cells.Cell(args.workload, ROOT)
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    state = cell.entry().State(cell, args.seed, device, card.tables(
        device, getattr(torch, cell.config['dtype'])))
    steps = len(state.steps)
    for k in range(steps):
        state.call(k)
        torch.cuda.synchronize(device)
    n = cell.workload['trace_calls']
    trace, times = runner.traced_calls(state.call, steps, n, state, device)
    idle = sum(b - a for a, b in trace.gaps())
    print(f'{args.workload}: {n} calls; per call: host '
          f'{1e3 * sum(times) / n:.3f} ms, card idle {1e-3 * idle / n:.3f} '
          f'ms, kernels {len(trace.kernels) / n:.1f}; '
          f'card {card.power_limit()}')
    print(f'{"span":30s} {"n":>5s} {"host ms":>9s} {"launches":>9s} '
          f'{"idle ms":>8s}')
    for name, count, host, launches, idle in split(trace, n):
        print(f'{name:30s} {count:5.1f} {host:9.3f} {launches:9.1f} '
              f'{idle:8.3f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
