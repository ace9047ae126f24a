"""Cells cut to a tiny grid for the CPU tests."""

import json
import os


def tiny_cell(name, grid=(6, 8), config=None, **options):
    """The cell with its grid cut to ``grid`` (CPU tests only); with
    ``config``, another configuration's file in place of its own, and
    ``options`` added to its entry's options."""
    from parcelbench.harness import cells
    cell = cells.Cell(name)
    if config is not None:
        with open(os.path.join(cells.HERE, 'configs', f'{config}.json')) as f:
            cell.config = json.load(f)
    cell.config['grid'] = list(grid)
    cell.workload['options'] = dict(cell.options, **options)
    return cell
