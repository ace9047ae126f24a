"""The numpy copies of the acceptance tiers' generators in ``chip_smoke.py``
against the JAX test modules' own.

The card's machine has no JAX, so ``chip_smoke.py`` (phase 15) and the
port's tier files make their inputs with copies of the generators of
``test_integration_serial.py``, ``test_pipeline_fuzz.py``,
``test_multicross_fuzz.py``, ``test_nan_fuzz.py`` and
``test_pathological.py``.  Each copy must return, array for array, what the
JAX test module's generator returns for the same seed.
"""

import numpy as np
import pytest

import chip_smoke
import test_integration_serial as jserial
import test_multicross_fuzz as jmulti
import test_nan_fuzz as jnan
import test_pathological as jpath
import test_pipeline_fuzz as jsweep


def assert_arrays_equal(want, got, what):
    if isinstance(want, dict):
        assert set(want) == set(got), what
        for k in want:
            assert_arrays_equal(want[k], got[k], f'{what}/{k}')
        return
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            assert_arrays_equal(a, b, f'{what}[{i}]')
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, what
    np.testing.assert_array_equal(want, got, err_msg=what)


@pytest.mark.parametrize('shape_seed', [(8, 8, 48, 7), (5, 5, 56, 23),
                                        (6, 6, 48, 11), (1, 12, 48, 404)])
def test_make_grid(shape_seed):
    ny, nx, L, seed = shape_seed
    assert_arrays_equal(jserial.make_grid(ny=ny, nx=nx, L=L, seed=seed),
                        chip_smoke.make_grid(ny=ny, nx=nx, L=L, seed=seed),
                        'make_grid')


@pytest.mark.parametrize('case', chip_smoke.SWEEP_CASES)
def test_sweep_columns(case):
    """The sweep fixture's p, t, td0, heights and winds for each class."""
    assert chip_smoke.SWEEP_CASES == jsweep.CASES
    assert (chip_smoke.SWEEP_N, chip_smoke.SWEEP_L) == (jsweep.N, jsweep.L)
    N, L = jsweep.N, jsweep.L
    seed = 400 + jsweep.CASES.index(case)
    rng = np.random.default_rng(seed)
    p, t, td0 = (v[0].copy() for v in jsweep.make_grid(ny=1, nx=N, L=L,
                                                       seed=seed))
    p, t, td0 = jsweep._mutate(case, p, t, td0, rng)
    h = 44330.0 * (1.0 - (np.where(np.isnan(p), 500.0, p)
                          / 1013.25) ** 0.19)
    h = np.where(np.isnan(p), np.nan, h)
    winds = {
        'surface_wind_u': rng.normal(3, 2, (N,)),
        'surface_wind_v': rng.normal(0, 2, (N,)),
        'wind_u': rng.normal(8, 5, (N, L)),
        'wind_v': rng.normal(2, 5, (N, L)),
        'wind_height_above_surface': np.broadcast_to(
            np.linspace(0.0, 16000.0, L), (N, L)).copy(),
    }
    got = chip_smoke.sweep_columns(case)
    assert_arrays_equal((p, t, td0, h, winds), got, case)
    nan_pmax, dup_p = chip_smoke.sweep_records(got[0])
    assert (nan_pmax > 0).any() == (case in ('interior_nan', 'combined'))
    assert any(len(d) for d in dup_p) == (case in ('dup_pressure',
                                                   'combined'))


def test_zigzag_columns():
    assert chip_smoke.MULTICROSS_L == jmulti.L
    for depression in ((1.0, 6.0), (9.0, 15.0)):
        want_rng = np.random.default_rng(20260820)
        got_rng = np.random.default_rng(20260820)
        for i in range(12):
            assert_arrays_equal(
                jmulti._zigzag_column(want_rng, depression=depression),
                chip_smoke.zigzag_column(got_rng, depression=depression),
                f'zigzag {depression} {i}')


@pytest.mark.parametrize('kind', ['base', 'deep'])
def test_multicross_sets(kind):
    """Both selected sets, columns and oracle answers, as the JAX module's
    fixtures select them."""
    fixture = jmulti.deep_fuzz_set if kind == 'deep' else jmulti.fuzz_set
    want_cols, want_serial = fixture._get_wrapped_function()()
    cols, serial = chip_smoke.multicross_set(kind)
    assert_arrays_equal(want_cols, cols, kind)
    for s, w in zip(serial, want_serial):
        assert_arrays_equal({k: w[k] for k in ('cape', 'cin', 'lfc', 'el',
                                               'pp', 'parcel_t', 'env_t')},
                            {k: s[k] for k in ('cape', 'cin', 'lfc', 'el',
                                               'pp', 'parcel_t', 'env_t')},
                            kind)
        assert (jmulti._crossing_stats(w) == chip_smoke.crossing_stats(s))
        assert (jmulti._increasing_crossings(w)
                == chip_smoke.increasing_crossings(s))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_nan_fuzz_grid(seed):
    assert_arrays_equal(jnan._fuzz_grid(seed), chip_smoke.nan_fuzz_grid(seed),
                        f'seed {seed}')


def test_all_nan_grid():
    assert chip_smoke.all_nan_grid().shape == (8, 16)
    assert np.isnan(chip_smoke.all_nan_grid()).all()


def test_pathological_grid_and_dataset():
    assert chip_smoke.PATHOLOGICAL_L == jpath.L
    want = jpath._pathological_grid()
    got = chip_smoke.pathological_grid()
    assert_arrays_equal(want, got, 'grid')
    assert_arrays_equal(jpath._as_dataset(*want),
                        chip_smoke.pathological_dataset(*got), 'dataset')
