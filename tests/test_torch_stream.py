"""The port's chunked and streamed execution against the JAX package's.

``parallel.chunked``/``scan_map`` and ``parallel.stream_map`` run a column
program over fixed-size chunks; both must equal running the program on each
NaN-padded chunk and concatenating (exactly: ``assert_array_equal``), and the
JAX package's ``scan_map``/``stream_map`` on the same inputs and the
corresponding program (``assert_same``: identical NaN patterns, 1e-9).  The
pipelines stream to the same values as whole calls: 1e-6 of each output's
scale in float64 (the chunk shape may change the order of a sum).  Here
everything runs on ``device='cpu'``; the pinned-buffer, three-stream path
exists only on a CUDA device and is held to the whole call in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu.parallel import scan_map as jscan_map
from xarray_parcel_tpu.parallel import stream_map as jstream_map
from xarray_parcel_tpu.parallel.chunked import pad_fill as jpad_fill
from xarray_parcel_tpu_torch import AdiabatTables
from xarray_parcel_tpu_torch import pipeline as tpipeline
from xarray_parcel_tpu_torch.parallel import (chunked, pad_fill, scan_map,
                                              stream_map)

import chip_smoke
from test_torch_ops import assert_same


def toy(dat):
    """A shape-exercising column program: a level reduction, a surface
    passthrough, a bool output and an int output."""
    s = torch.nansum(dat['pressure'] * dat['temperature'], -1)
    return {'s': s + dat['surface'], 'flag': s > 0,
            'count': (~torch.isnan(dat['pressure'])).to(torch.int32).sum(-1),
            'twice': dat['pressure'] * 2}


def jtoy(dat):
    s = jnp.nansum(dat['pressure'] * dat['temperature'], axis=-1)
    return {'s': s + dat['surface'], 'flag': s > 0,
            'count': jnp.sum(jnp.asarray(~jnp.isnan(dat['pressure']),
                                         jnp.int32), axis=-1),
            'twice': dat['pressure'] * 2}


def toy_dat(B, L=7, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(100.0, 1000.0, (B, L))
    p[rng.random((B, L)) < 0.1] = np.nan
    return {'pressure': p, 'temperature': rng.normal(260.0, 20.0, (B, L)),
            'surface': rng.normal(0.0, 1.0, (B,)),
            'ids': rng.integers(0, 9, (B,)).astype(np.int32)}


def tensors(dat):
    return {k: torch.from_numpy(v) for k, v in dat.items()}


def per_chunk_reference(fn, dat, C):
    """``fn`` on each padded chunk, concatenated: the exactness oracle."""
    B = next(iter(dat.values())).shape[0]
    outs = []
    for start in range(0, B, C):
        stop = min(start + C, B)
        pad = C - (stop - start)
        chunk = {}
        for k, v in dat.items():
            c = v[start:stop]
            if pad:
                value = np.nan if c.dtype.kind == 'f' else 0
                c = np.pad(c, [(0, pad)] + [(0, 0)] * (c.ndim - 1),
                           constant_values=value)
            chunk[k] = torch.from_numpy(np.ascontiguousarray(c))
        outs.append({k: v.numpy()[:stop - start]
                     for k, v in fn(chunk).items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize('B,C', [(24, 8), (23, 8), (5, 8), (8, 8), (17, 4)])
def test_chunked_equals_per_chunk(B, C):
    dat = toy_dat(B)
    want = per_chunk_reference(toy, dat, min(C, B))
    got = scan_map(toy, tensors(dat), chunk_columns=C)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].shape[0] == B and got[k].dtype == toy(
            tensors(dat))[k].dtype


@pytest.mark.parametrize('B,C', [(23, 8), (5, 8)])
def test_chunked_matches_jax_scan_map(B, C):
    dat = toy_dat(B, seed=2)
    want = jscan_map(jtoy, {k: jnp.asarray(v) for k, v in dat.items()},
                     chunk_columns=C)
    assert_same(want, chunked(toy, C)(tensors(dat)))


def test_chunked_takes_nested_outputs_and_the_empty_batch():
    dat = tensors(toy_dat(11, seed=4))
    got = chunked(lambda d: (toy(d), [d['surface'] + 1]), 4)(dat)
    whole = toy(dat)
    assert torch.equal(got[0]['twice'].nan_to_num(), whole['twice'].nan_to_num())
    assert torch.equal(got[1][0], dat['surface'] + 1)
    empty = scan_map(toy, {k: v[:0] for k, v in dat.items()}, 4)
    assert empty['s'].shape == (0,) and empty['twice'].shape == (0, 7)


def test_chunked_refuses_bad_inputs():
    dat = tensors(toy_dat(8))
    dat['surface'] = dat['surface'][:4]
    with pytest.raises(ValueError, match='mixed leading batch dims'):
        chunked(toy)(dat)
    with pytest.raises(ValueError, match='0-d'):
        chunked(toy)({'pressure': torch.tensor(1.0)})
    with pytest.raises(ValueError, match='empty'):
        chunked(toy)({})


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32, np.bool_])
def test_pad_fill_matches_jax(dtype):
    a, b = pad_fill(dtype), jpad_fill(dtype)
    assert (np.isnan(a) and np.isnan(b)) or a == b
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    c = pad_fill(tdt)
    assert (np.isnan(a) and np.isnan(c)) or a == c


# --- stream_map --------------------------------------------------------------

@pytest.mark.parametrize('B,C', [(24, 8), (23, 8), (5, 8), (1, 4)],
                         ids=['divides', 'ragged', 'one-chunk', 'one-column'])
def test_stream_map_equals_per_chunk(B, C):
    dat = toy_dat(B, seed=5)
    want = per_chunk_reference(toy, dat, min(C, B))
    got = stream_map(toy, dat, batch_columns=C, device='cpu')
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stream_map_matches_jax_on_a_grid():
    """A (ny, nx, L) grid, a chunk that does not divide it."""
    flat = toy_dat(35, seed=6)
    dat = {k: v.reshape((5, 7) + v.shape[1:]) for k, v in flat.items()}
    want = jstream_map(jtoy, dat, batch_columns=8)
    got = stream_map(toy, dat, batch_columns=8, device='cpu')
    assert got['s'].shape == (5, 7) and got['twice'].shape == (5, 7, 7)
    assert_same(want, got)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k


def test_stream_map_empty_batch():
    dat = {k: v[:0] for k, v in toy_dat(4).items()}
    want = jstream_map(jtoy, dat, batch_columns=8)
    got = stream_map(toy, dat, batch_columns=8, device='cpu')
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
    assert got['twice'].shape == (0, 7)


def test_stream_map_takes_broadcast_views_and_needs_a_level_variable():
    flat = toy_dat(12, seed=7)
    dat = dict(flat, pressure=np.broadcast_to(flat['pressure'][0], (12, 7)))
    got = stream_map(toy, dat, batch_columns=5, device='cpu')
    want = toy(tensors({k: np.ascontiguousarray(v) for k, v in dat.items()}))
    np.testing.assert_array_equal(got['s'], want['s'].numpy())
    with pytest.raises(ValueError, match='no level variable'):
        stream_map(toy, {'surface': flat['surface']}, device='cpu')


def test_stream_map_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device exists')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        stream_map(toy, toy_dat(4))


@pytest.fixture(scope='module')
def tables():
    jt = jad.load_moist_adiabat_lookups()
    return jt, AdiabatTables.from_numpy(np.asarray(jt.coeffs), 'cpu',
                                        torch.float64)


@pytest.mark.parametrize('name', ['conv_properties_fused',
                                  'min_conv_properties_fused'])
def test_pipeline_streams_to_the_whole_call(tables, name):
    """The fused pipelines streamed in chunks of 7 of 30 columns against one
    whole call (1e-6 of scale), and against the JAX package's ``stream_map``
    of its pipeline (1e-6 of scale)."""
    jt, tt = tables
    dat, _ = chip_smoke.synthetic(30, L=24)
    dat = {k: v.astype(np.float64) for k, v in dat.items()}
    dat['temperature'][3, 5] = np.nan                    # a poisoned column
    fn = getattr(tpipeline, name)
    got = stream_map(lambda d: fn(d, tables=tt), dat, batch_columns=7,
                     device='cpu')
    whole = fn(tensors(dat), tables=tt)
    jfn = getattr(jpipeline, name)
    want = jstream_map(lambda d: jfn(d, tables=jt), dat, batch_columns=7)
    assert set(got) == set(whole) == set(want)
    for k, v in whole.items():
        ref = v.numpy()
        scale = 1.0 if ref.dtype == bool else max(
            1.0, float(np.nanmax(np.abs(ref), initial=0.0)))
        assert_same(ref, got[k], atol=1e-6 * scale, rtol=0, name=k)
        assert_same(np.asarray(want[k]), got[k], atol=1e-6 * scale, rtol=0,
                    name=f'jax/{k}')
    if 'mu_cape' in got:                 # the full pipeline masks the column
        assert np.isnan(got['mu_cape'][3])
