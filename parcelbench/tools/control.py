"""The control of the comparison that decides ``correct``: the reference,
put in the program's place and computed in bfloat16 (the precision below
the configuration's float32), must come out as not correct.

    python3 parcelbench/tools/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the cell's inputs at the cell's own size, takes the
sample of columns a run judges (both time steps), works them out with the
reference in float64 and in bfloat16, and prints the compared numbers of
the bfloat16 result beside the cell's limits, one JSON line per seed.
The benchmark's runs never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def control_numbers(cell, seed, device, dtype):
    """The compared numbers of the reference in ``dtype`` against the
    reference in float64 on the sample a run of ``cell`` judges."""
    import numpy as np
    import torch
    from parcelbench.harness import check, runner
    from parcelbench.reference import pipeline as reference

    state = cell.entry().State(cell, seed, device, None)
    idx = runner.sample_columns(seed, state.columns)
    parts = [state.sample_inputs(k, idx) for k in range(len(state.steps))]
    state.close()
    ins = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    ignore_nans = bool(cell.config['ignore_nans'])
    n = len(ins['temperature'])

    def host(out):
        return {k: (v.cpu().numpy() if v.dtype == torch.bool
                    else v.to(torch.float64).cpu().numpy())
                for k, v in out.items()}

    want = host(reference.conv_properties_blocks(
        {k: v.to(torch.float64) for k, v in ins.items()},
        ignore_nans=ignore_nans, block=n))
    got = host(reference.conv_properties_blocks(
        {k: v.to(dtype) for k, v in ins.items()},
        ignore_nans=ignore_nans, block=n))
    numbers = check.compare(got, want)
    numbers['nan_outputs'] = float(np.mean([np.isnan(v).mean()
                                            for v in got.values()
                                            if v.dtype != bool]))
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from parcelbench.harness import cells

    cell = cells.Cell(args.workload, ROOT)
    device = torch.device(args.device)
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, device, torch.bfloat16)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'control': numbers,
                          'limits': cell.workload['limits']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
