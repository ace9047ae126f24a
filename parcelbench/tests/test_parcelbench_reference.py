"""The plain reference: it agrees with the program's CPU path at a tiny
size, its bfloat16 control comes out not correct, and it imports nothing
of the program, of JAX or of the JAX package."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parcelbench.harness import card, check, cells
from parcelbench.reference import pipeline as reference
from parcelbench.tests.tiny import tiny_cell
from parcelbench.tools.control import control_numbers

CPU = torch.device('cpu')
REFERENCE_DIR = os.path.join(cells.HERE, 'reference')


@pytest.mark.parametrize('name', ['aus400_ml90.device_full',
                                  'era5_pl35.device_full'])
def test_reference_agrees_with_the_programs_cpu_path(name, table_cache):
    from xarray_parcel_tpu_torch import pipeline
    cell = tiny_cell(name, grid=(8, 12))
    tables = card.tables(CPU, torch.float64)
    state = cell.entry().State(cell, 21, CPU, tables)
    dat = {k: v.to(torch.float64) for k, v in state.steps[0].items()}
    ignore_nans = bool(cell.config['ignore_nans'])
    got = pipeline.conv_properties_fused(dat, ignore_nans=ignore_nans,
                                         tables=tables)
    want = reference.conv_properties(dat, ignore_nans=ignore_nans)
    assert set(got) == set(want) == set(reference.OUTPUTS)
    numbers = check.compare({k: v.numpy() for k, v in got.items()},
                            {k: v.numpy() for k, v in want.items()})
    # The program's spectral tables against the integrated adiabats.
    assert numbers['p99_rel'] < 1e-4, numbers
    assert numbers['off_share'] == 0.0, numbers
    for k in reference.OUTPUTS:
        assert np.array_equal(np.isnan(got[k].numpy().astype(float)),
                              np.isnan(want[k].numpy().astype(float))), k


@pytest.mark.parametrize('name', ['aus400_ml90.dataset_full',
                                  'era5_pl35.device_full'])
def test_bfloat16_control_is_not_correct(name):
    cell = tiny_cell(name, grid=(8, 12))
    numbers = control_numbers(cell, 31, CPU, torch.bfloat16)
    correct, checks = check.verdict(numbers, 0, cell.workload['limits'])
    assert not correct, checks


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_torch_and_itself_only():
    for dirpath, _, files in os.walk(REFERENCE_DIR):
        for f in files:
            if f.endswith('.py'):
                tops = {m.split('.')[0] for m in
                        _imports(os.path.join(dirpath, f))}
                assert tops <= {'math', 'torch', 'numpy'}, (f, tops)


def test_loading_the_harness_loads_no_jax():
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'from parcelbench.harness import cells, runner\n'
        'for w in cells.benchmark()["workloads"]:\n'
        '    c = cells.Cell(w["name"]); c.entry()\n'
        '    [c.reader(m) for m in c.end_to_end + c.per_layer]\n'
        'import parcelbench.tools.control\n'
        'print(runner.forbidden_modules())\n' % cells.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == '[]'


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA card')
    proc = subprocess.run(
        [sys.executable, os.path.join(cells.HERE, 'run.py'), '--workload',
         'era5_pl35.device_full', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, timeout=300,
        cwd=cells.ROOT)
    assert proc.returncode != 0 and proc.stdout == ''
