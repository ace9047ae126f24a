"""Tolerance comparison utilities: the validation harness's reporting layer.

Port of ``xarray_parcel_tpu.utils.compare`` (the reference's ``compare`` /
``compare_results``): per-variable max absolute and relative difference
with NaN-pattern equality, reported as a table, for oracle-vs-vector and
cross-version result diffs.  Host-side numpy; tensors (on any device) are
brought to the host first.
"""

import warnings

import numpy as np


def _host(x):
    """``x`` as a float64 numpy array; a tensor is detached and copied to
    the host first."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def compare(x, y, name='value', tolerance=1e-5):
    """Compare array ``x`` to reference ``y``.

    Returns a dict with max_abs_diff, max_rel_diff_pct, nan_pattern_equal,
    within_tolerance; NaNs are excluded from diffs but their patterns must
    match for ``within_tolerance``.
    """
    x, y = np.broadcast_arrays(_host(x), _host(y))

    nan_equal = bool((np.isnan(x) == np.isnan(y)).all())
    diffs = np.abs(x - y)
    with np.errstate(divide='ignore', invalid='ignore'):
        rel = diffs / np.abs(y) * 100.0
    # nanmax on an all-NaN slice (all-NaN variable, or 0/0 relative diffs)
    # is a 0.0 drift, not a warning.
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        max_abs = float(np.nanmax(diffs)) if diffs.size else 0.0
        max_rel = float(np.nanmax(rel)) if rel.size else 0.0
    if np.isnan(max_abs):
        max_abs = 0.0                       # all-NaN comparison
    if np.isnan(max_rel):
        max_rel = 0.0
    ok = nan_equal and max_abs <= tolerance
    return {'name': name, 'max_abs_diff': max_abs,
            'max_rel_diff_pct': max_rel, 'nan_pattern_equal': nan_equal,
            'within_tolerance': ok}


def compare_results(set1, set2, tolerance=1e-5, print_report=True):
    """Compare every variable of ``set1`` against reference ``set2``.

    Returns the list of per-variable reports (and prints the reference's
    diff table by default).
    """
    reports = []
    if print_report:
        print(f'{"Differences":45} {"Max abs. diff":>16} '
              f'{"Max rel. diff":>16} {"NaN ok":>7}')
    for variable in set2:
        rep = compare(set1[variable], set2[variable], name=variable,
                      tolerance=tolerance)
        reports.append(rep)
        if print_report:
            flag = '' if rep['within_tolerance'] else '  <-- DIFFERS'
            print(f'{variable:45} {rep["max_abs_diff"]:16.6g} '
                  f'{rep["max_rel_diff_pct"]:15.4g}% '
                  f'{str(rep["nan_pattern_equal"]):>7}{flag}')
    return reports


def _load_archive(arch):
    """A path to an .npz, an NpzFile, or a plain dict -> dict of out_*
    variables (archive 'out_' prefixes stripped; non-archive dicts pass
    through whole)."""
    if isinstance(arch, (str, bytes)) or hasattr(arch, '__fspath__'):
        arch = np.load(arch)
    keys = list(arch.keys()) if hasattr(arch, 'keys') else list(arch.files)
    out = {k[4:]: np.asarray(arch[k]) for k in keys if k.startswith('out_')}
    return out if out else {k: np.asarray(arch[k]) for k in keys
                            if not k.startswith('in_')}


def compare_archives(current, historic, tolerance=1e-5, print_report=True):
    """Variable-by-variable drift between two result archives: the
    reference's cross-version evaluation for the .npz regression archives
    (or any two dicts of arrays).  Pass paths, NpzFiles, or dicts; archive
    ``out_`` prefixes are stripped.

    Returns ``{'variables': [per-variable compare() reports],
    'only_in_current': [...], 'only_in_historic': [...],
    'n_differs': int, 'equal': bool}``; ``equal`` is True iff the key sets
    match and every shared variable is within tolerance with an identical
    NaN pattern.
    """
    cur = _load_archive(current)
    hist = _load_archive(historic)
    shared = [k for k in hist if k in cur]
    only_cur = sorted(k for k in cur if k not in hist)
    only_hist = sorted(k for k in hist if k not in cur)
    reports = compare_results({k: cur[k] for k in shared},
                              {k: hist[k] for k in shared},
                              tolerance=tolerance, print_report=print_report)
    n_differs = sum(not r['within_tolerance'] for r in reports)
    if print_report:
        for k in only_cur:
            print(f'{k:45} {"(only in current)":>16}')
        for k in only_hist:
            print(f'{k:45} {"(only in historic)":>16}')
        print(f'{n_differs} of {len(shared)} shared variables exceed '
              f'tolerance {tolerance:g}')
    return {'variables': reports, 'only_in_current': only_cur,
            'only_in_historic': only_hist, 'n_differs': n_differs,
            'equal': not (n_differs or only_cur or only_hist)}
