"""The port's examples run end to end on the CPU at a small size:
``examples/demo_torch.py``, ``examples/xarray_demo_torch.py`` and
``examples/multichip_torch.py`` (a 4-entry host mesh), each with
``--device cpu``, on the JAX package's cached coefficients (building them
on the CPU takes minutes)."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu_torch import AdiabatTables

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'examples')


@pytest.fixture(scope='module')
def tables():
    return AdiabatTables.from_numpy(
        np.asarray(jad.load_moist_adiabat_lookups().coeffs), 'cpu',
        torch.float64)


def check_demo(out):
    assert len(out) == 21
    assert all(r['nan_pattern_equal'] and r['within_tolerance']
               for r in out)


def check_xarray_demo(out):
    assert len(out.data_vars) == 21
    assert np.isfinite(np.asarray(out['mu_cape'].values)).any()


def check_multichip(out):
    assert len(out) == 21 and out['mu_cape'].shape == (36,)


CASES = {
    'demo_torch': (['--grid', '4'], check_demo),
    'xarray_demo_torch': (['--grid', '4'], check_xarray_demo),
    'multichip_torch': (['--grid', '6', '--entries', '4'], check_multichip),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_example_runs_on_the_cpu(tables, name, capsys):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    argv, check = CASES[name]
    out = importlib.import_module(name).main(['--device', 'cpu', *argv],
                                             tables=tables)
    check(out)
    assert capsys.readouterr().out
