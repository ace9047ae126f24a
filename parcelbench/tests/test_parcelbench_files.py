"""Every file the benchmark finds by name is there and keeps the rules of
``BENCHMARK.json``'s format."""

import json
import os
import re

import pytest

from parcelbench.harness import cells

ROOT = cells.ROOT
BENCH = cells.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'parcelbench/run.py']
    assert BENCH['paths'] == ['parcelbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 65536


def test_names_units_and_texts():
    entries = (BENCH['configs'] + BENCH['workloads'] + BENCH['end_to_end']
               + BENCH['per_layer'])
    for e in entries:
        assert NAME.match(e['name']), e['name']
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for e in BENCH['configs'] + BENCH['workloads']:
        assert 1 <= len(e['why']) <= 200 and '\n' not in e['why']
    for m in BENCH['per_layer']:
        assert 1 <= len(m['layer']) <= 200


@pytest.mark.parametrize('config', BENCH['configs'],
                         ids=lambda c: c['name'])
def test_config_file(config):
    assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
    assert config['file'] == f'parcelbench/configs/{config["name"]}.json'
    with open(os.path.join(ROOT, config['file'])) as f:
        data = json.load(f)
    assert data['name'] == config['name']
    assert data['reduced'] == config['reduced']
    for key in config['reduced']:
        assert NAME.match(key) and key in data
    assert any(w['config'] == config['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('name', CELLS)
def test_cell_finds_its_pieces(name):
    cell = cells.Cell(name)
    assert cell.chips == 1
    assert hasattr(cell.entry(), 'State')
    reported = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m['moves'] in reported
        assert callable(cell.reader(m))
    for m in cell.end_to_end:
        assert callable(cell.reader(m))
    limits = cell.workload['limits']
    assert set(limits) == {'p99_rel', 'off_share', 'layout'}
    assert limits['layout'] == 0


def test_metric_workloads_name_cells():
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        for w in m.get('workloads', []):
            assert w in CELLS
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert {m['name'] for m in BENCH['end_to_end']} >= {'setup_s'}


def test_every_workload_file_is_a_cell():
    found = sorted(f[:-5] for f in os.listdir(
        os.path.join(ROOT, 'parcelbench', 'workloads')))
    assert found == sorted(CELLS)
