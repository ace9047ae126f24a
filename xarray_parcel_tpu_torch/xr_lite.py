"""Minimal Dataset/DataArray: xarray's duck-typed core subset.

The port's own copy of ``xarray_parcel_tpu.xr_lite``.  The compute core is
plain torch, with :mod:`xarray_parcel_tpu_torch.xarray_api` as the
Dataset-shaped boundary.  xarray itself is an optional dependency: when it
is absent, this module provides the small structural subset the boundary
(and its tests) use: named dims, ``values``/``attrs``, ``transpose`` with
partial dim orders, ``coords``, item/attribute access and Dataset
construction from ``(dims, data[, attrs])`` tuples.  It holds NumPy data
only and implements no compute.

A clean-room implementation of the public xarray API shape, not vendored
xarray code.  Unlike the JAX package's copy, :func:`merge` raises on
conflicting variables, as xarray's default does.
"""

import numpy as np


class DataArray:
    """A named-dims array: ``data`` + ``dims`` + ``attrs`` + ``coords``."""

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        self.values = np.asarray(data)
        if dims is None:
            dims = tuple(f'dim_{i}' for i in range(self.values.ndim))
        self.dims = tuple(dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError(
                f'{len(self.dims)} dims for {self.values.ndim}-d data')
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})
        self.name = name

    @property
    def data(self):
        return self.values    # xarray exposes both .data and .values

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def shape(self):
        return self.values.shape

    @property
    def sizes(self):
        return dict(zip(self.dims, self.values.shape))

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def transpose(self, *dims):
        if not dims:
            dims = tuple(reversed(self.dims))   # xarray: bare transpose()
        order = [d for d in dims if d in self.dims]
        order += [d for d in self.dims if d not in order]
        axes = [self.dims.index(d) for d in order]
        return DataArray(self.values.transpose(axes), tuple(order),
                         coords=self.coords, attrs=self.attrs,
                         name=self.name)

    def copy(self):
        return DataArray(self.values.copy(), self.dims, coords=self.coords,
                         attrs=self.attrs, name=self.name)

    def __repr__(self):
        return (f'<xr_lite.DataArray {self.name or ""}{self.dims} '
                f'{self.values.shape} {self.values.dtype}>')


def _as_dataarray(name, value):
    if isinstance(value, DataArray):
        return DataArray(value.values, value.dims, coords=value.coords,
                         attrs=value.attrs, name=name)
    if isinstance(value, tuple):
        dims, data = value[0], value[1]
        attrs = value[2] if len(value) > 2 else None
        if isinstance(dims, str):
            dims = (dims,)
        return DataArray(data, dims, attrs=attrs, name=name)
    return DataArray(value, name=name)


class Dataset:
    """A dict of DataArrays sharing named dims, plus coords."""

    def __init__(self, data_vars=None, coords=None):
        self.data_vars = {}
        self.coords = {}
        for name, value in (data_vars or {}).items():
            self.data_vars[name] = _as_dataarray(name, value)
        for name, value in (coords or {}).items():
            self.coords[name] = _as_dataarray(name, value) \
                if not isinstance(value, DataArray) else value

    @property
    def dims(self):
        out = {}
        for da in self.data_vars.values():
            for d, n in zip(da.dims, da.shape):
                if d in out and out[d] != n:
                    raise ValueError(f'conflicting sizes for dim {d!r}')
                out[d] = n
        return out

    sizes = dims

    def __getitem__(self, name):
        if name in self.data_vars:
            return self.data_vars[name]
        if name in self.coords:
            return self.coords[name]
        raise KeyError(name)

    def __setitem__(self, name, value):
        self.data_vars[name] = _as_dataarray(name, value)

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    def __iter__(self):
        return iter(self.data_vars)

    def __getattr__(self, name):
        # Guard the attributes __getattr__ itself reads: during unpickling /
        # copy the instance dict is empty and an unguarded lookup would
        # recurse forever.
        if name in ('data_vars', 'coords'):
            raise AttributeError(name)
        try:
            return self.data_vars[name]
        except KeyError:
            pass
        try:
            return self.coords[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self):
        out = Dataset()
        out.data_vars = {k: v.copy() for k, v in self.data_vars.items()}
        out.coords = dict(self.coords)
        return out

    def transpose(self, *dims):
        out = Dataset()
        out.data_vars = {k: v.transpose(*dims)
                         for k, v in self.data_vars.items()}
        out.coords = dict(self.coords)
        return out

    def assign_coords(self, coords=None, **kwargs):
        # New containers, shared variable data (as xarray does): a deep
        # value copy per assign would double memory on every lifted grid.
        out = Dataset()
        out.data_vars = dict(self.data_vars)
        out.coords = dict(self.coords)
        for name, value in {**(coords or {}), **kwargs}.items():
            out.coords[name] = value if isinstance(value, DataArray) \
                else _as_dataarray(name, value)
        return out

    def __repr__(self):
        vars_ = ', '.join(f'{k}{v.dims}' for k, v in self.data_vars.items())
        return f'<xr_lite.Dataset dims={self.dims} vars=[{vars_}]>'


def _same(a, b):
    """Whether two DataArrays agree: same dims, shape and values (NaNs in
    the same places count as equal)."""
    if a.dims != b.dims or a.shape != b.shape:
        return False
    x, y = a.values, b.values
    if x.dtype.kind == 'f' or y.dtype.kind == 'f':
        return bool(np.array_equal(x, y, equal_nan=True))
    return bool(np.array_equal(x, y))


def merge(objects):
    """Merge Datasets and named DataArrays into one Dataset.

    A variable or coordinate that appears more than once must agree in
    dims and values; a conflict raises ``ValueError``, as xarray's default
    ``compat='no_conflicts'`` does for overlapping values."""
    out = Dataset()

    def put(target, kind, name, value):
        if not isinstance(value, DataArray):
            value = _as_dataarray(name, value)
        if name in target and not _same(target[name], value):
            raise ValueError(f'conflicting values for {kind} {name!r} on '
                             f'objects to be merged')
        target.setdefault(name, value)

    for obj in objects:
        if isinstance(obj, DataArray):
            if obj.name is None:
                raise ValueError('cannot merge an unnamed DataArray')
            put(out.data_vars, 'variable', obj.name, obj)
            coords = obj.coords or {}
        else:
            for name, da in obj.data_vars.items():
                put(out.data_vars, 'variable', name, da)
            coords = obj.coords
        for name, c in coords.items():
            put(out.coords, 'coordinate', name, c)
    return out
