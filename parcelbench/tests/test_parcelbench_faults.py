"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: the call returns its state unchanged
(the same outputs whatever the time step), half of the columns are left
out, and an answer is altered where it is produced.  A sound run comes
out correct.  The run skips the look for a card and runs on the CPU at a
tiny size; the cells hold one chip, so no exchange between chips can be
left out."""

import time

import numpy as np
import pytest
import torch

from parcelbench.harness import runner
from parcelbench.tests.tiny import tiny_cell

CPU = torch.device('cpu')
# The cells, and the ERA5 Dataset streamed through the same entry.
CELLS = [('aus400_ml90.dataset_full', None, {}),
         ('era5_pl35.device_full', None, {}),
         ('aus400_ml90.device_full', None, {}),
         ('aus400_ml90.dataset_full', 'era5_pl35', {'stream_columns': 16})]
IDS = ['aus400_ml90.dataset_full', 'era5_pl35.device_full',
       'aus400_ml90.device_full', 'era5_pl35.dataset_streamed']


def _edit(out, fn):
    """Apply ``fn(name, array)`` to each output of a call, in place, for
    a dict of tensors or a Dataset."""
    if isinstance(out, dict):
        for k, v in out.items():
            out[k] = torch.from_numpy(fn(k, v.numpy().copy()))
    else:
        for k in out.data_vars:
            arr = np.asarray(out[k].values)
            arr[...] = fn(k, arr.copy())
    return out


def unchanged(call):
    first = []

    def wrapped(k):
        if not first:
            first.append(call(k))
        return first[0]
    return wrapped


def half_left_out(call):
    def drop(name, a):
        flat = a.reshape(-1)
        flat[flat.size // 2:] = False if a.dtype == bool else np.nan
        return a
    return lambda k: _edit(call(k), drop)


def answer_altered(call):
    def shift(name, a):
        return a + np.float32(0.5) if name == 'mu_lifted_index' else a
    return lambda k: _edit(call(k), shift)


def _run(case, wrap_call):
    name, config, options = case
    cell = tiny_cell(name, grid=(6, 8), config=config, **options)
    result, notes = runner.run(cell, 2 ** 33 + 5, 0.3, False, CPU,
                               time.time(), wrap_call=wrap_call)
    return result


@pytest.mark.parametrize('case', CELLS, ids=IDS)
def test_sound_run_is_correct(case, table_cache):
    result = _run(case, None)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'


@pytest.mark.parametrize('fault', [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize('case', CELLS, ids=IDS)
def test_broken_run_is_not_correct(case, fault, table_cache):
    result = _run(case, fault)
    assert not result['correct'], result['checks']
