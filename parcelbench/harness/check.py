"""The comparison that decides ``correct``.

The program's outputs at a sample of columns are held against the plain
reference's on the same input columns.  Three numbers are compared, each
against its limit from the cell's workload file:

- ``p99_rel``: over every float output, the 99th percentile of
  |program - reference| / scale on the columns where both are finite; the
  worst output's.  ``scale`` is the output's largest |reference| on the
  sample, at least 1 (the float32 budget's measure).
- ``off_share``: the share of sampled columns in which some output is off
  by more than ``COLUMN_TOL`` of its scale, is finite on one side only, or
  is a boolean that differs.
- ``layout``: outputs missing or extra, and outputs whose dims, coords,
  shape, dtype or device are not what the call returns (exact: limit 0).
"""

import numpy as np

COLUMN_TOL = 1e-2


def compare(program, reference):
    """The numbers for dicts of equal-length 1-D host arrays keyed alike
    (the reference's keys are the ones compared)."""
    n = len(next(iter(reference.values())))
    off = np.zeros(n, bool)
    worst = 0.0
    worst_name = None
    for name, ref in reference.items():
        got = program[name]
        if ref.dtype == bool or got.dtype == bool:
            off |= got.astype(bool) != ref.astype(bool)
            continue
        got = got.astype(np.float64)
        ref = ref.astype(np.float64)
        fin_ref, fin_got = np.isfinite(ref), np.isfinite(got)
        off |= fin_ref != fin_got
        both = fin_ref & fin_got
        if not both.any():
            continue
        scale = max(1.0, float(np.abs(ref[fin_ref]).max()))
        rel = np.abs(got - ref) / scale
        off |= both & (rel > COLUMN_TOL)
        p99 = float(np.quantile(rel[both], 0.99))
        if p99 > worst or worst_name is None:
            worst, worst_name = p99, name
    return {'p99_rel': worst, 'off_share': float(off.mean()),
            'worst_output': worst_name}


def verdict(numbers, layout, limits):
    """``(correct, checks)``: ``checks`` maps each compared number's short
    name to its value and limit, in a fixed order."""
    values = {'p99_rel': numbers['p99_rel'],
              'off_share': numbers['off_share'], 'layout': layout}
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in values.items()}
    correct = all(np.isfinite(v) and v <= limits[k]
                  for k, v in values.items())
    return correct, checks
