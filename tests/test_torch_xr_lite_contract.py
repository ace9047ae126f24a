"""The port's ``xr_lite`` under the nine contract behaviours of
``test_xr_lite_contract.py``: the small subset of xarray's API that the
port's ``xarray_api`` boundary relies on, each pinned to xarray's
documented semantics, and run against real xarray as well whenever it is
importable.

The same assertions on the port's ``xr_lite`` and, for the boundary round
trip, the port's ``xarray_api.from_dataset``/``to_dataset``.  Where the
port differs on purpose: its ``merge`` raises on conflicting variables and
coordinates, which the JAX package's copy merges silently (ROADMAP section
C); :func:`test_merge_raises_on_conflicts_where_the_jax_copy_does_not`
holds that difference.
"""

import numpy as np
import pytest

import xarray_parcel_tpu.xr_lite as jxr_lite
import xarray_parcel_tpu_torch.xr_lite as xr_lite

BACKENDS = [pytest.param(xr_lite, id='xr_lite')]
try:                                    # pragma: no cover - env-dependent
    import xarray
    BACKENDS.append(pytest.param(xarray, id='xarray'))
except ImportError:
    pass


@pytest.fixture(params=BACKENDS)
def xr(request):
    return request.param


def _ds(xr):
    rng = np.random.default_rng(7)
    return xr.Dataset(
        {'temperature': (('y', 'x', 'lev'), rng.normal(280, 5, (2, 3, 4)),
                         {'units': 'K'}),
         'pressure': ('lev', np.linspace(1000., 700., 4))},
        coords={'y': np.arange(2.), 'x': np.arange(3.),
                'lev': np.arange(4)})


def test_construction_from_tuples(xr):
    ds = _ds(xr)
    assert tuple(ds['temperature'].dims) == ('y', 'x', 'lev')
    assert tuple(ds['pressure'].dims) == ('lev',)
    assert ds['temperature'].attrs == {'units': 'K'}
    assert ds['temperature'].shape == (2, 3, 4)
    assert dict(ds.dims)['lev'] == 4


def test_getitem_precedence_and_membership(xr):
    ds = _ds(xr)
    assert np.asarray(ds['pressure']).shape == (4,)
    assert np.asarray(ds['x']).tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(KeyError):
        ds['nope']
    assert 'temperature' in ds and 'x' in ds and 'nope' not in ds


def test_iteration_yields_data_var_names(xr):
    ds = _ds(xr)
    assert sorted(ds) == ['pressure', 'temperature']
    assert sorted(ds.data_vars) == ['pressure', 'temperature']


def test_transpose_complete_permutation(xr):
    da = _ds(xr)['temperature']
    out = da.transpose('lev', 'y', 'x')
    assert tuple(out.dims) == ('lev', 'y', 'x')
    np.testing.assert_array_equal(np.asarray(out),
                                  np.transpose(np.asarray(da), (2, 0, 1)))
    assert tuple(da.transpose().dims) == ('lev', 'x', 'y')
    np.testing.assert_array_equal(np.asarray(da.transpose('y', 'x', 'lev')),
                                  np.asarray(da))


def test_assign_coords_returns_new_object(xr):
    ds = _ds(xr)
    out = ds.assign_coords({'z': np.arange(5.)})
    assert 'z' in out.coords and 'z' not in ds.coords
    np.testing.assert_array_equal(np.asarray(out.coords['z'].values),
                                  np.arange(5.))
    assert 'x' in out.coords


def test_copy_isolation(xr):
    ds = _ds(xr)
    cp = ds.copy()
    cp['extra'] = (('lev',), np.ones(4))
    assert 'extra' in cp and 'extra' not in ds
    np.testing.assert_array_equal(np.asarray(cp['temperature']),
                                  np.asarray(ds['temperature']))


def test_coords_expose_values(xr):
    c = _ds(xr).coords['lev']
    assert np.asarray(c.values if hasattr(c, 'values') else c).tolist() == \
        [0, 1, 2, 3]


def test_dataarray_surface(xr):
    da = xr.DataArray(np.arange(6.).reshape(2, 3), dims=('a', 'b'),
                      attrs={'units': 'K'}, name='t')
    assert da.name == 't' and da.dims == ('a', 'b')
    assert da.shape == (2, 3) and da.attrs['units'] == 'K'
    np.testing.assert_array_equal(np.asarray(da),
                                  np.arange(6.).reshape(2, 3))
    np.testing.assert_array_equal(da.values, np.asarray(da))


def test_boundary_round_trip(xr, monkeypatch):
    """The port's boundary functions over either backend: ``from_dataset``
    lowers a mixed-dims Dataset, ``to_dataset`` lifts results back with
    attrs and coords."""
    from xarray_parcel_tpu_torch import xarray_api
    monkeypatch.setattr(xarray_api, 'xr', xr)
    rng = np.random.default_rng(3)
    L = 5
    ds = xr.Dataset(
        {'pressure': (('model_level_number',), np.linspace(1000., 500., L)),
         'temperature': (('latitude', 'longitude', 'model_level_number'),
                         rng.normal(280, 5, (2, 3, L))),
         'surface_wind_u': (('longitude',), rng.normal(0, 1, 3))},
        coords={'latitude': np.arange(2.), 'longitude': np.arange(3.),
                'model_level_number': np.arange(L)})
    fields, batch_dims = xarray_api.from_dataset(
        ds, variables=['pressure', 'temperature', 'surface_wind_u'])
    assert batch_dims == ('latitude', 'longitude')
    assert fields['pressure'].shape == (L,)
    assert fields['surface_wind_u'].shape == (3,)
    assert fields['temperature'].shape == (2, 3, L)
    out = xarray_api.to_dataset(
        {'cape': np.zeros((2, 3)), 'track': np.zeros((2, 3, L))},
        batch_dims, coords={d: ds.coords[d] for d in batch_dims})
    assert tuple(out['cape'].dims) == ('latitude', 'longitude')
    assert tuple(out['track'].dims) == ('latitude', 'longitude',
                                        'model_level_number')
    assert out['cape'].attrs.get('units') == 'J kg$^{-1}$'
    np.testing.assert_array_equal(np.asarray(out.coords['latitude'].values),
                                  np.arange(2.))


def test_merge_raises_on_conflicts_where_the_jax_copy_does_not():
    a = {'t': (('y',), np.array([1.0, 2.0]))}
    b = {'t': (('y',), np.array([1.0, 3.0]))}
    merged = jxr_lite.merge([jxr_lite.Dataset(a), jxr_lite.Dataset(b)])
    assert 't' in merged
    with pytest.raises(ValueError):
        xr_lite.merge([xr_lite.Dataset(a), xr_lite.Dataset(b)])
