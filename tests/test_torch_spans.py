"""The port's ``xparcel.*`` spans on the CPU.

Under ``torch.profiler`` the Dataset pipelines record one span per layer
boundary (``_build.span``): the Dataset surface's stages, the fused
pipeline and its outputs, each parcel prep, the pre-pass and both kernels
(their plain twins on the CPU).  The trace must hold each as often as the
pipeline calls it, nested as the calls nest.  No tolerance is involved:
the counts and the nesting are exact, and the outputs with a profiler
running are bit-equal to those without.  With no profiler running a span
enters nothing of the profiler.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu_torch import AdiabatTables, _build
from xarray_parcel_tpu_torch import pipeline as tpipeline
from xarray_parcel_tpu_torch import xarray_api as tx

import chip_smoke

DATASET = {'xparcel.dataset.lower': (1, None),
           'xparcel.dataset.to_device': (1, None),
           'xparcel.dataset.compute': (1, None),
           'xparcel.dataset.to_host': (1, None),
           'xparcel.dataset.lift': (1, None),
           'xparcel.pipeline': (1, 'xparcel.dataset.compute'),
           'xparcel.pipeline.outputs': (1, 'xparcel.pipeline'),
           'xparcel.prep.dewpoint': (1, 'xparcel.pipeline'),
           'xparcel.kernel.tail': (1, 'xparcel.pipeline')}
# Each span's (count, innermost enclosing span) in a Dataset call.  The
# mixed layers of a call sit in one span (parcels.mix_layers); on the CPU
# its twin's conserved fields and neighbours nest in it.
SPANS = {
    'conv_properties_fused': {
        **DATASET,
        'xparcel.prep.most_unstable': (1, 'xparcel.pipeline'),
        'xparcel.prep.conserved': (1, 'xparcel.prep.mix_layer'),
        'xparcel.prep.neighbors': (1, 'xparcel.prep.mix_layer'),
        'xparcel.prep.mix_layer': (1, 'xparcel.pipeline'),
        'xparcel.prep.prepass': (3, 'xparcel.pipeline'),
        'xparcel.kernel.solve': (3, 'xparcel.pipeline')},
    'min_conv_properties_fused': {
        **DATASET,
        'xparcel.prep.conserved': (1, 'xparcel.prep.mix_layer'),
        'xparcel.prep.neighbors': (1, 'xparcel.prep.mix_layer'),
        'xparcel.prep.mix_layer': (1, 'xparcel.pipeline'),
        'xparcel.prep.prepass': (1, 'xparcel.pipeline'),
        'xparcel.kernel.solve': (1, 'xparcel.pipeline')},
}


@pytest.fixture(scope='module')
def tables():
    return AdiabatTables.from_numpy(
        np.asarray(jad.load_moist_adiabat_lookups().coeffs), 'cpu',
        torch.float32)


def small_dataset():
    dat_np, td = chip_smoke.synthetic(4 * 5, L=24, seed=5)
    return chip_smoke.grid_dataset(dat_np, td, (4, 5))


def traced_spans(fn, tmp_path):
    """``fn()`` under the profiler; returns its result and the trace's
    ``xparcel.*`` spans as (start, end, name), sorted by start and, at one
    start, the longer first."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
             for e in events if e.get('ph') == 'X'
             and str(e.get('name', '')).startswith('xparcel.')]
    return out, sorted(spans, key=lambda s: (s[0], -s[1]))


def parents(spans):
    """Each span's innermost enclosing span (None at the top level)."""
    out, open_ = [], []
    for a, b, name in spans:
        while open_ and open_[-1][1] < b:
            open_.pop()
        out.append((name, open_[-1][2] if open_ else None))
        open_.append((a, b, name))
    return out


@pytest.mark.parametrize('name', sorted(SPANS))
def test_dataset_call_holds_every_span_nested(name, tables, tmp_path):
    """Every span of the Dataset call, as often as the pipeline calls its
    function, inside the span of its caller."""
    ds = small_dataset()
    fn = getattr(tx, name)
    _, spans = traced_spans(lambda: fn(ds, tables=tables, device='cpu'),
                            tmp_path)
    found = {}
    for span, parent in parents(spans):
        count, _ = found.get(span, (0, None))
        assert parent == SPANS[name][span][1], (span, parent)
        found[span] = (count + 1, parent)
    assert found == SPANS[name]


@pytest.mark.parametrize('name', sorted(SPANS))
def test_outputs_are_bit_equal_with_and_without_a_profiler(name, tables,
                                                           tmp_path):
    dat_np, _ = chip_smoke.synthetic(16, L=24, seed=9)
    dat_np['temperature'][2, 4] = np.nan            # a masked column
    dat = {k: torch.from_numpy(v) for k, v in dat_np.items()}
    fn = getattr(tpipeline, name)
    plain = fn(dat, tables=tables)
    traced, spans = traced_spans(lambda: fn(dat, tables=tables), tmp_path)
    assert spans
    assert set(plain) == set(traced)
    for k in plain:
        np.testing.assert_array_equal(plain[k].numpy(), traced[k].numpy(),
                                      err_msg=k)


def test_span_enters_nothing_without_a_profiler(tables, monkeypatch,
                                                tmp_path):
    """What a span would enter raises: a Dataset call with no profiler
    running never reaches it; under a profiler the first span does."""
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) entered')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert not torch.autograd._profiler_enabled()
    assert _build.span('xparcel.test') is _build.span('xparcel.other')
    ds = small_dataset()
    out = tx.conv_properties_fused(ds, tables=tables, device='cpu')
    assert 'mu_cape' in out.data_vars
    with pytest.raises(AssertionError, match='xparcel.dataset.lower'):
        traced_spans(lambda: tx.conv_properties_fused(
            ds, tables=tables, device='cpu'), tmp_path)
