"""The ensemble cell and the streamed ERA5 cell at a tiny size on the CPU.

The ensemble entry (``entries/device_chunked.py``: every member of a time
step in one batch, ``parallel.scan_map`` over the fused pipeline) agrees
with the plain reference in float64; a run comes out correct, and not
correct with its timed path broken three ways (one chunk's outputs shifted
by a column, one member's outputs left out, ``mu_lifted_index`` off by
0.5 K); the bfloat16 control comes out not correct.
``chunk_idle_ms.chunked`` reads a synthetic trace as worked out by hand.
The cell's workload file and configuration keep the benchmark's rules.
"""

import time

import numpy as np
import pytest
import torch

from parcelbench.harness import card, cells, check, runner, tracing
from parcelbench.reference import pipeline as reference
from parcelbench.tests.test_parcelbench_faults import _edit, answer_altered
from parcelbench.tests.test_parcelbench_metrics import WORK, events, reader
from parcelbench.tests.tiny import tiny_cell
from parcelbench.tools.control import control_numbers

CPU = torch.device('cpu')
ENSEMBLE = 'gencast_ens50_pl13.device_chunked'
GRID = (6, 8)
MEMBERS = 3
COLUMNS = GRID[0] * GRID[1]             # a member's columns
# One member a chunk, as the cell's chunks hold whole members.
CHUNK = COLUMNS
SEED = 2 ** 33 + 5


def ensemble_cell(**options):
    return tiny_cell(ENSEMBLE, grid=GRID,
                     **dict({'members': MEMBERS, 'chunk_columns': CHUNK},
                            **options))


def test_ensemble_entry_agrees_with_the_reference(table_cache):
    cell = ensemble_cell(chunk_columns=CHUNK + 5)       # the last padded
    tables = card.tables(CPU, torch.float64)
    state = cell.entry().State(cell, 21, CPU, tables)
    assert state.columns == MEMBERS * COLUMNS
    assert state.work[0]['levels'] == 13
    state.steps = [{k: v.to(torch.float64) for k, v in s.items()}
                   for s in state.steps]
    got = state.call(1)
    want = reference.conv_properties(state.steps[1], ignore_nans=True)
    assert set(got) == set(want) == set(reference.OUTPUTS)
    numbers = check.compare({k: v.numpy() for k, v in got.items()},
                            {k: v.numpy() for k, v in want.items()})
    # The program's spectral tables against the integrated adiabats.
    assert numbers['p99_rel'] < 1e-4, numbers
    assert numbers['off_share'] == 0.0, numbers
    for k in reference.OUTPUTS:
        assert np.array_equal(np.isnan(got[k].numpy().astype(float)),
                              np.isnan(want[k].numpy().astype(float))), k
    # The members are distinct draws, each with levels below ground.
    t = state.steps[1]['temperature'].reshape(MEMBERS, COLUMNS, -1)
    assert not torch.equal(t[0], t[1])
    assert all(bool(torch.isnan(t[m]).any()) for m in range(MEMBERS))


def chunk_shifted(call):
    """The second chunk's outputs shifted by a column."""
    def shift(name, a):
        a[CHUNK:2 * CHUNK] = np.roll(a[CHUNK:2 * CHUNK], 1)
        return a
    return lambda k: _edit(call(k), shift)


def member_left_out(call):
    """The last member's outputs never computed: NaN, and False."""
    def drop(name, a):
        a[(MEMBERS - 1) * COLUMNS:] = False if a.dtype == bool else np.nan
        return a
    return lambda k: _edit(call(k), drop)


def _run(cell, wrap_call):
    result, _ = runner.run(cell, SEED, 0.3, False, CPU, time.time(),
                           wrap_call=wrap_call)
    return result


def test_sound_ensemble_run_is_correct(table_cache):
    result = _run(ensemble_cell(), None)
    assert result['correct'], result['checks']
    assert 'device_columns_per_s' in result['metrics']


@pytest.mark.parametrize('fault', [chunk_shifted, member_left_out,
                                   answer_altered])
def test_broken_ensemble_run_is_not_correct(fault, table_cache):
    result = _run(ensemble_cell(), fault)
    assert not result['correct'], result['checks']


def test_ensemble_bfloat16_control_is_not_correct():
    cell = ensemble_cell()
    numbers = control_numbers(cell, 31, CPU, torch.bfloat16)
    correct, checks = check.verdict(numbers, 0, cell.workload['limits'])
    assert not correct, checks


def chunked_trace():
    """``test_parcelbench_metrics``' trace with the chunked spans: slices
    at 5-15, 60-90 (the card busy), 105-125 and a nested one at 112-118;
    gathers at 380-420 and 820-840; a prep span at 255-300, which is not
    the loop's."""
    def span(name, ts, dur):
        return dict(ph='X', cat='user_annotation', name=name, ts=ts, dur=dur)

    extra = [span(f'xparcel.chunked.{name}', ts, dur) for name, ts, dur in (
        ('slice', 5, 10), ('slice', 60, 30), ('slice', 105, 20),
        ('slice', 112, 6), ('gather', 380, 40), ('gather', 820, 20))]
    extra.append(span('xparcel.prep.conserved', 255, 45))
    return tracing.parse(events() + extra, [WORK, WORK])


def test_chunk_idle_overlaps_gaps_with_the_span_union():
    # gaps: 0-10, 110-120, 250-600, 640-700, 800-850, 900-1000; under the
    # chunked spans: 5-10, 110-120, 380-420 and 820-840, 75 us in all,
    # over 2 calls, in ms
    assert reader('chunk_idle_ms.chunked')(chunked_trace()) == (
        pytest.approx(0.0375))


def test_chunk_idle_without_its_spans_returns_nothing():
    """A program whose loop records no span (the parent of the spans)
    gives no reading, and the result line leaves the metric out."""
    t = tracing.parse(events(), [WORK, WORK])
    assert reader('chunk_idle_ms.chunked')(t) is None


def test_workload_file_and_configuration():
    bench = cells.benchmark()
    ens = cells.Cell(ENSEMBLE)
    assert ens.chips == 1 and ens.workload['entry'] == 'device_chunked'
    assert ens.workload['trace_calls'] == 2
    assert ens.workload['limits'] == cells.Cell(
        'era5_pl35.device_full').workload['limits']
    assert ens.options == {'members': 50, 'chunk_columns': 5191200}
    assert {m['name'] for m in ens.end_to_end} == {
        'device_columns_per_s', 'peak_device_gib', 'setup_s'}
    assert 'chunk_idle_ms.chunked' in {m['name'] for m in ens.per_layer}
    cfg = ens.config
    B = cfg['members'] * int(np.prod(cfg['grid']))
    # Ten chunks of five whole members: none padded.
    assert B == 51_912_000 and B == 10 * ens.options['chunk_columns']
    assert ens.options['chunk_columns'] == 5 * int(np.prod(cfg['grid']))
    assert cfg['members'] == ens.options['members']
    assert cfg['chunk_columns'] == ens.options['chunk_columns']
    assert cfg['pressure_levels'] == cfg['source_pressure_levels']
    assert len(cfg['pressure_levels']) == 13 and cfg['dtype'] == 'float32'
    assert all(k in cfg for k in cfg['assumed'])
    era5 = cells.Cell('era5_pl35.device_full').config
    for k in ('surface', 'profiles', 'wind', 'coarse_grid', 'pressure',
              'below_ground_nan', 'ignore_nans', 'grid'):
        assert cfg[k] == era5[k], k
    entry = next(c for c in bench['configs']
                 if c['name'] == 'gencast_ens50_pl13')
    assert entry['reduced'] == cfg['reduced'] == []
