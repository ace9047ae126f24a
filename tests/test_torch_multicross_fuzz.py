"""The port through the multi-crossing LFC/EL fuzz of
``test_multicross_fuzz.py``: zigzag soundings whose environment oscillates
around the parcel's own track, against the serial oracle.

The same two sets (``chip_smoke.multicross_set``: 24 columns with >= 2
increasing and decreasing crossings >= 8 hPa apart, and 8 high-LCL columns
where the exclusion or LCL-substitution rules decide the LFC), the same
exact-ODE backend without the virtual-temperature correction, and the same
tolerances: LFC/EL NaN together or within 1 hPa, CAPE/CIN within 1.5 J/kg;
the parcel variants compared where the oracle's own crossings stay 8 hPa
apart and both sides launch the same parcel, on at least 16 columns.  Also:
the fused solve (the kernel's plain twin, on the spectral tables) on both
sets under the same tolerances, and the port's ``cape_cin`` against the
JAX package's on the base set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu_torch import AdiabatTables, adiabat, cape, fused
from xarray_parcel_tpu_torch import parcels

import chip_smoke
import serial_oracle as oracle

ML = dict(moist_lapse=adiabat.moist_lapse_integrate)


def tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope='module')
def fuzz_set():
    return chip_smoke.multicross_set('base')


@pytest.fixture(scope='module')
def deep_fuzz_set():
    return chip_smoke.multicross_set('deep')


def run_cape_cin(cols):
    p, t, td, t0, td0 = chip_smoke.stack_columns(cols)
    res, prof = cape.cape_cin(*tensors(p, t, td, t0, p[:, 0], td0),
                              virtual_temperature_correction=False, **ML)
    return (res['cape'].numpy(), res['cin'].numpy(),
            prof['lfc_pressure'].numpy(), prof['el_pressure'].numpy())


def test_multicross_lfc_el_and_areas(fuzz_set):
    cols, serial = fuzz_set
    chip_smoke.check_multicross('base', serial, *run_cape_cin(cols))


def test_multicross_exclusion_rules_vs_serial(deep_fuzz_set):
    """Where the bottom-most increasing crossing is rejected (below or at
    the high LCL), the same exclusion and substitution rules as the
    oracle."""
    cols, serial = deep_fuzz_set
    chip_smoke.check_multicross('deep', serial, *run_cape_cin(cols))


def _variant_vs_serial(fuzz_set, vector_fn, oracle_fn):
    cols, _ = fuzz_set
    p, t, td, _, _ = chip_smoke.stack_columns(cols)
    res, prof, parcel = vector_fn(*tensors(p, t, td),
                                  virtual_temperature_correction=False, **ML)
    cape_v, cin_v = res['cape'].numpy(), res['cin'].numpy()
    lfc_v = prof['lfc_pressure'].numpy()
    el_v = prof['el_pressure'].numpy()
    parcel_p_v = parcel['pressure'].numpy()
    keep, serial = [], []
    for i in range(len(cols)):
        s = oracle_fn(p[i], t[i], td[i], virtual_temperature_correction=False)
        serial.append(s)
        _, _, gap = chip_smoke.crossing_stats(s)
        # Near-coincident crossings (ill-posed branch) and theta-e argmax
        # ties resolved differently (different parcels) are not compared.
        keep.append(gap >= 8.0 and not (
            'parcel_pressure' in s
            and abs(parcel_p_v[i] - s['parcel_pressure']) > 1e-6))
    chip_smoke.check_multicross('variant', serial, cape_v, cin_v, lfc_v, el_v,
                                keep=keep)
    assert sum(keep) >= 16, f'only {sum(keep)} of {len(cols)} comparable'


def test_multicross_most_unstable_vs_serial(fuzz_set):
    _variant_vs_serial(fuzz_set, parcels.most_unstable_cape_cin,
                       oracle.most_unstable_cape_cin_column)


def test_multicross_mixed_layer_vs_serial(fuzz_set):
    _variant_vs_serial(fuzz_set, parcels.mixed_layer_cape_cin,
                       oracle.mixed_layer_cape_cin_column)


def test_multicross_sets_are_adversarial(fuzz_set, deep_fuzz_set):
    _, serial = fuzz_set
    multi = 0
    for s in serial:
        inc_x = chip_smoke.increasing_crossings(s)
        if not np.isnan(s['lfc']) and len(inc_x) >= 2 and \
                abs(s['lfc'] - max(inc_x)) < 1e-9:
            multi += 1
    assert multi >= len(serial) // 2
    _, deep_serial = deep_fuzz_set
    for s in deep_serial:
        inc_x = chip_smoke.increasing_crossings(s)
        assert len(inc_x) >= 2
        assert np.isnan(s['lfc']) or abs(s['lfc'] - max(inc_x)) > 1.0


@pytest.fixture(scope='module')
def tables():
    return AdiabatTables.from_numpy(
        np.asarray(jad.load_moist_adiabat_lookups().coeffs), 'cpu',
        torch.float64)


@pytest.mark.parametrize('kind', ['base', 'deep'])
def test_multicross_fused_vs_serial(fuzz_set, deep_fuzz_set, tables, kind):
    """The fused solve without the virtual-temperature correction on the
    spectral tables: the same crossings and areas as the oracle, and the
    modular path on the same tables to 1e-10 of scale."""
    cols, serial = deep_fuzz_set if kind == 'deep' else fuzz_set
    p, t, td, t0, td0 = chip_smoke.stack_columns(cols)
    args = tensors(p, t, td)
    parcel = dict(zip(('parcel_pressure', 'parcel_temperature',
                       'parcel_dewpoint'), tensors(p[:, 0], t0, td0)))
    res, sol = fused.fused_cape_cin(*args, **parcel, tables=tables,
                                    virtual_temperature_correction=False)
    chip_smoke.check_multicross(f'{kind} fused', serial, res['cape'].numpy(),
                                res['cin'].numpy(),
                                sol['lfc_pressure'].numpy(),
                                sol['el_pressure'].numpy())
    mres, mprof = cape.cape_cin(*args, parcel['parcel_temperature'],
                                parcel['parcel_pressure'],
                                parcel['parcel_dewpoint'], tables=tables,
                                virtual_temperature_correction=False)
    want = {**mres, **{k: mprof[k] for k in sol}}
    assert not chip_smoke.exact_misses(kind, want, {**res, **sol})


def test_port_matches_jax_on_the_base_set(fuzz_set):
    cols, _ = fuzz_set
    p, t, td, t0, td0 = chip_smoke.stack_columns(cols)
    want, wprof = jcape.cape_cin(
        *(jnp.asarray(x) for x in (p, t, td, t0, p[:, 0], td0)),
        virtual_temperature_correction=False,
        moist_lapse=jad.moist_lapse_integrate)
    got, gprof = cape.cape_cin(*tensors(p, t, td, t0, p[:, 0], td0),
                               virtual_temperature_correction=False, **ML)
    keys = ('lfc_pressure', 'el_pressure', 'lfc_temperature',
            'el_temperature')
    assert not chip_smoke.exact_misses(
        'base vs JAX', {**{k: np.asarray(v) for k, v in want.items()},
                        **{k: np.asarray(wprof[k]) for k in keys}},
        {**got, **{k: gprof[k] for k in keys}}, rel=1e-9)
