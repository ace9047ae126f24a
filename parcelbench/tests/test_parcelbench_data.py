"""The seeded generator: the same seed gives the same inputs, and each
configuration's layout, pressure and NaN rules hold."""

import numpy as np
import pytest
import torch

from parcelbench.data.columns import LEVEL_VARS, make_fields
from parcelbench.tests.tiny import tiny_cell

CPU = torch.device('cpu')


@pytest.mark.parametrize('config', ['aus400_ml90', 'era5_pl35'])
def test_same_seed_same_inputs(config):
    cfg = tiny_cell(f'{config}.device_full').config
    a = make_fields(cfg, 2 ** 40 + 3, 0, CPU)
    b = make_fields(cfg, 2 ** 40 + 3, 0, CPU)
    c = make_fields(cfg, 2 ** 40 + 4, 0, CPU)
    d = make_fields(cfg, 2 ** 40 + 3, 1, CPU)
    for k in a:
        assert torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k]))
    assert not torch.equal(a['temperature'], c['temperature'])
    assert not torch.equal(a['temperature'], d['temperature'])


def test_aus400_terrain_following_and_nan_free():
    cfg = tiny_cell('aus400_ml90.device_full').config
    f = make_fields(cfg, 5, 0, CPU)
    p = f['pressure']
    assert p.shape == tuple(cfg['grid']) + (cfg['levels'],)
    for k in LEVEL_VARS:
        assert torch.isfinite(f[k]).all(), k
    assert (p[..., 1:] < p[..., :-1]).all()
    sigma = p / f['surface_pressure'][..., None]
    assert torch.allclose(sigma, sigma[:1, :1], rtol=1e-5)
    assert 100.0 < float(p[..., -1].min()) and float(p[..., -1].max()) < 130.0
    assert (f['specific_humidity'] > 0).all()
    assert (f['wind_height_above_surface'][..., 0] > 0).all()


def test_era5_isobaric_levels_and_below_ground_nan():
    cfg = tiny_cell('era5_pl35.device_full', grid=(24, 32)).config
    f = make_fields(cfg, 6, 0, CPU)
    assert f['pressure'].shape == (35,)
    assert f['pressure'].tolist() == [float(x) for x in
                                      cfg['pressure_levels']]
    below = f['pressure'] > f['surface_pressure'][..., None]
    assert below.any() and (~below).any()
    for k in LEVEL_VARS[1:]:
        v = f[k]
        assert torch.isnan(v[below]).all() and torch.isfinite(v[~below]).all()


def test_dataset_layout_is_level_leading(table_cache):
    from parcelbench.harness import card
    cell = tiny_cell('aus400_ml90.dataset_full', config='era5_pl35')
    state = cell.entry().State(cell, 7, CPU, card.tables(CPU,
                                                          torch.float32))
    ds = state.steps[0]
    vert, dims = cell.config['vert_dim'], tuple(cell.config['batch_dims'])
    assert tuple(ds['temperature'].dims) == (vert,) + dims
    assert tuple(ds['pressure'].dims) == (vert,)
    assert tuple(ds['surface_wind_u'].dims) == dims
    assert np.asarray(ds['temperature'].values).dtype == np.float32
