"""Find a cell's pieces by name.

``BENCHMARK.json`` names the cell's configuration, its traffic and the
metrics it reports; each piece is a file of its own under
``parcelbench/``: ``configs/<config>.json`` (through the configuration's
``file``), ``workloads/<cell>.json`` (the entry that drives the cell and
its options), ``entries/<entry>.py`` and ``metrics/<metric>.py``.  A
later cell or metric is a new file and a new entry in ``BENCHMARK.json``;
nothing here names one.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def benchmark(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric, cell):
    """Whether ``cell`` reports ``metric`` (a metric without
    ``workloads`` is reported by every cell)."""
    return 'workloads' not in metric or cell in metric['workloads']


class Cell:
    """One cell: its ``BENCHMARK.json`` entry, configuration, workload
    file, entry module and the metrics it reports."""

    def __init__(self, name, root=ROOT):
        bench = benchmark(root)
        found = [w for w in bench['workloads'] if w['name'] == name]
        if not found:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json')
        self.name = name
        self.spec = found[0]
        config = [c for c in bench['configs']
                  if c['name'] == self.spec['config']][0]
        with open(os.path.join(root, config['file'])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, 'workloads', f'{name}.json')) as f:
            self.workload = json.load(f)
        if (self.workload['config'], self.workload['traffic']) != (
                self.spec['config'], self.spec['traffic']):
            raise ValueError(f'workloads/{name}.json names another config '
                             f'or traffic than BENCHMARK.json')
        self.chips = self.spec['chips']
        self.end_to_end = [m for m in bench['end_to_end']
                           if reports(m, name)]
        self.per_layer = [m for m in bench['per_layer'] if reports(m, name)]

    @property
    def options(self):
        return self.workload.get('options', {})

    def entry(self):
        name = self.workload['entry']
        return _load_module(os.path.join(HERE, 'entries', f'{name}.py'),
                            f'parcelbench_entry_{name}')

    def reader(self, metric):
        """The ``read(trace)`` function of a per-layer metric."""
        name = metric['name']
        return _load_module(os.path.join(HERE, 'metrics', f'{name}.py'),
                            'parcelbench_metric_' + name.replace('.', '_')
                            ).read
