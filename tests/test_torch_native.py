"""The port's C++ ingest (``native``) against its numpy forms and against
the JAX package's ``native``.

The six cases of ``tests/test_native.py``, each run three ways on the same
seeded inputs: through the port's C++ library (built here with g++), through
the port's numpy forms (the library switched off), and through the JAX
package's module.  These are copies, casts and comparisons, so every result
is held exactly (``assert_array_equal``; NaNs in the same places).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import native as jnative
from xarray_parcel_tpu import ops as jops
from xarray_parcel_tpu_torch import _build, native


@pytest.fixture
def numpy_path(monkeypatch):
    """Within the test, the port's ``native`` runs its numpy forms."""
    native.available()                  # the build has been tried
    monkeypatch.setattr(native, '_lib', None)


def both_paths(fn, *args):
    """``fn(*args)`` through the C++ library and through numpy."""
    assert native.available()
    got = fn(*args)
    saved, native._lib = native._lib, None
    try:
        assert not native.available()
        fallback = fn(*args)
    finally:
        native._lib = saved
    return got, fallback


def test_native_builds_into_the_build_directory():
    assert native.available(), 'g++ build of the ingest library failed'
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == _build.BUILD_DIR
    # Named by its source and flags, not kept beside the source.
    assert not [f for f in os.listdir(os.path.dirname(native.__file__))
                if f.endswith('.so')]


def test_validate_columns():
    p = np.array([[1000., 900., 800., np.nan],      # ok: NaN padding at top
                  [1000., 900., 950., 800.],        # bad: not decreasing
                  [1000., np.nan, 900., 800.],      # bad: NaN then values
                  [1000., 999., 998., 997.],        # ok
                  [1000., 1000., 900., 800.],       # bad: not strict
                  [np.nan, 900., 800., 700.]],      # bad: leading NaN
                 np.float64)
    expect = np.array([True, False, False, True, False, False])
    for dtype in (np.float64, np.float32):
        got, fallback = both_paths(native.validate_columns, p.astype(dtype))
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(fallback, expect)
        np.testing.assert_array_equal(
            jnative.validate_columns(p.astype(dtype)), expect)
    # Batch dims are kept.
    assert native.validate_columns(p.reshape(2, 3, 4)).shape == (2, 3)


def test_validate_matches_fallback():
    rng = np.random.default_rng(0)
    p = -np.sort(-rng.uniform(100, 1050, (64, 30)), axis=-1)
    p[3, 5] = p[3, 4]                     # duplicate -> invalid
    p[7, 25:] = np.nan                    # top padding -> valid
    p[9, 10] = np.nan                     # interior NaN -> invalid
    got, fallback = both_paths(native.validate_columns, p)
    np.testing.assert_array_equal(got, fallback)
    np.testing.assert_array_equal(got, jnative.validate_columns(p))
    assert not got[3] and got[7] and not got[9] and got.sum() == 62


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_repack_and_transpose(dtype):
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (40, 7, 9)).astype(dtype)
    got, fallback = both_paths(native.repack_to_f32, a)
    np.testing.assert_array_equal(got, a.astype(np.float32))
    np.testing.assert_array_equal(fallback, got)
    np.testing.assert_array_equal(got, jnative.repack_to_f32(a))
    got, fallback = both_paths(native.levels_to_last, a)
    np.testing.assert_array_equal(got,
                                  np.moveaxis(a, 0, -1).astype(np.float32))
    np.testing.assert_array_equal(fallback, got)
    np.testing.assert_array_equal(got, jnative.levels_to_last(a))
    assert got.dtype == np.float32 and got.flags['C_CONTIGUOUS']
    assert got.shape == (7, 9, 40)


def test_levels_to_last_threaded_numpy_and_odd_inputs(numpy_path):
    """The numpy form's threaded branch (a grid past its threshold) and
    the inputs the C++ entry points do not take."""
    rng = np.random.default_rng(3)
    big = rng.normal(0, 1, (5, 1024, 1024)).astype(np.float32)
    assert big.size >= native._THREADED_FROM
    np.testing.assert_array_equal(native.levels_to_last(big),
                                  np.moveaxis(big, 0, -1))
    strided = big[:, ::2, ::3]
    np.testing.assert_array_equal(native.levels_to_last(strided),
                                  np.moveaxis(strided, 0, -1))
    ints = np.arange(24).reshape(4, 6)
    assert native.levels_to_last(ints).dtype == np.float32


def test_compact_left_matches_device_op():
    rng = np.random.default_rng(2)
    p = -np.sort(-rng.uniform(100, 1050, (32, 16)), axis=-1)
    lead = rng.integers(0, 5, 32)
    for i, n in enumerate(lead):
        p[i, :n] = np.nan
    p[5] = np.nan                          # an all-NaN column stays as it is
    t = rng.normal(280, 10, (32, 16))
    t[np.isnan(p)] = np.nan
    fields = {'pressure': p.astype(np.float32), 't': t.astype(np.float32)}

    host, fallback = both_paths(native.compact_left, fields, 'pressure')
    jhost = jnative.compact_left(fields, 'pressure')
    dev = jops.compact_left({k: jnp.asarray(v) for k, v in fields.items()},
                            'pressure')
    for k in fields:
        np.testing.assert_array_equal(host[k], fallback[k])
        np.testing.assert_array_equal(host[k], jhost[k])
        np.testing.assert_array_equal(host[k], np.asarray(dev[k], np.float32))
        # New arrays: the inputs are untouched.
        assert host[k] is not fields[k]
    np.testing.assert_array_equal(np.isnan(fields['pressure'][:, 0]),
                                  np.isnan(p[:, 0]))


def test_compact_left_preserves_f64():
    """compact_left is dtype-preserving: float64 arrays compact in float64,
    mixed-dtype dicts keep each leaf's dtype, and the result matches the
    float32 kernel's pattern exactly."""
    rng = np.random.default_rng(7)
    p = -np.sort(-rng.uniform(100, 1050, (16, 12)), axis=-1)
    for i, n in enumerate(rng.integers(0, 4, 16)):
        p[i, :n] = np.nan
    t = rng.normal(280, 10, (16, 12))
    t[np.isnan(p)] = np.nan
    out64, fb64 = both_paths(native.compact_left, {'pressure': p, 't': t},
                             'pressure')
    j64 = jnative.compact_left({'pressure': p, 't': t}, 'pressure')
    for k in out64:
        assert out64[k].dtype == np.float64
        np.testing.assert_array_equal(out64[k], fb64[k])
        np.testing.assert_array_equal(out64[k], j64[k])
    mixed, fbmixed = both_paths(
        native.compact_left, {'pressure': p.astype(np.float32), 't64': t},
        'pressure')
    assert mixed['pressure'].dtype == np.float32
    assert mixed['t64'].dtype == np.float64
    np.testing.assert_array_equal(mixed['t64'], fbmixed['t64'])
    np.testing.assert_array_equal(mixed['t64'], out64['t'])
    ref32 = native.compact_left(
        {'pressure': p.astype(np.float32), 't': t.astype(np.float32)},
        'pressure')
    np.testing.assert_array_equal(mixed['t64'].astype(np.float32),
                                  ref32['t'])
    ints = native.compact_left({'pressure': p.astype(np.float32),
                                'ids': np.arange(16 * 12).reshape(16, 12)},
                               'pressure')
    assert ints['ids'].dtype == np.float32
