"""Parcel selection: mixed-layer and most-unstable parcels, and their
CAPE/CIN wrappers.

Port of ``xarray_parcel_tpu.parcels``.  Columns keep a static level count:
a sub-parcel prefix is NaN-masked instead of compacted away, and every
downstream op is first-valid-index aware.

On a CUDA tensor :func:`bridge_neighbors` runs in the hand-written kernel
``csrc/neighbors.cu`` (a thread per row, the tile staged in shared
memory), :func:`mix_layers`, every mixed layer of a fused pipeline call,
in ``csrc/mix_layer.cu``, and :func:`from_most_unstable_parcel` in
``csrc/most_unstable.cu`` (likewise); on a CPU tensor each runs in its
plain twin (``_bridge_neighbors_twin``, ``_mix_layers_twin``,
``_most_unstable_twin``), all through the seam (:mod:`._kernels`).
"""

import torch

from . import thermo
from ._build import span
from ._kernels import Kernel
from .cape import cape_cin
from .ops import get_layer, insert_level, interp_many, nanmax, notnan


def _bridge_neighbors_twin(pressure, valid):
    """:func:`bridge_neighbors` as plain torch ops (the kernel's twin):
    exclusive cumulative min/max scans along the level axis."""
    run_min = torch.cummin(torch.where(valid, pressure, torch.inf), -1)[0]
    prev_raw = torch.cat([torch.full_like(run_min[..., :1], torch.inf),
                          run_min[..., :-1]], -1)
    masked = torch.where(valid, pressure, -torch.inf)
    run_max = torch.cummax(masked.flip(-1), -1)[0].flip(-1)
    next_raw = torch.cat(
        [run_max[..., 1:],
         torch.full_like(run_max[..., :1], -torch.inf)], -1)
    return prev_raw, next_raw


def _neighbors_on_card(launch, pressure, valid):
    """:data:`bridge_neighbors_kernel` on CUDA tensors: the library's
    ``bridge_neighbors_<dtype>``."""
    if valid.dtype != torch.bool:
        raise TypeError(f'valid must be bool, not {valid.dtype}')
    shape = valid.shape
    if (valid.dim() == 0 or pressure.dim() == 0
            or pressure.dim() > valid.dim()
            or pressure.shape[-1] != shape[-1]
            or any(s not in (1, v) for s, v in zip(pressure.shape[::-1],
                                                   shape[::-1]))):
        raise ValueError(f'pressure {tuple(pressure.shape)} does not '
                         f'broadcast to valid {tuple(shape)}')
    # One allocation for both: they live and die together.
    prev, nxt = torch.empty((2, *shape), dtype=pressure.dtype,
                            device=pressure.device).unbind(0)
    if prev.numel() > 0:
        rows, row_stride = _kernel_rows(pressure, shape)
        B, L = rows.shape
        mask = valid.reshape(B, L).contiguous()
        launch('bridge_neighbors', [rows.data_ptr(), mask.data_ptr(),
                                    prev.data_ptr(), nxt.data_ptr()],
               B, L, row_stride)
    return prev, nxt


def _kernel_rows(pressure, shape):
    """The pressure as the kernel reads it, broadcast to the non-empty
    ``shape``: ``(rows, row_stride)``, B rows of L levels with unit level
    stride, ``row_stride`` values apart (0 where every row is one row,
    else L).  A view where the layout is one of these, else a contiguous
    copy."""
    L = shape[-1]
    rows = pressure.expand(shape).reshape(-1, L)
    B = rows.shape[0]
    if ((L > 1 and rows.stride(1) != 1)
            or (B > 1 and rows.stride(0) not in (0, L))):
        rows = rows.contiguous()
    return rows, (0 if B > 1 and rows.stride(0) == 0 else L)


#: :func:`bridge_neighbors` on a (…, L) ``pressure`` and a bool ``valid``
#: of the shape the pressure broadcasts to, on one device; returns (prev,
#: next) of ``valid``'s shape.  CUDA tensors go to the hand-written kernel
#: (``bridge_neighbors_kernel.launches`` counts each launch): pressure
#: float32 or float64.  A pressure whose rows are one row (row stride 0:
#: 1-D levels broadcast) is read in place, as is a contiguous one; any
#: other layout is made contiguous.  CPU tensors go to the plain twin.
#: The pressure takes a gradient, through the twin's VJP; the mask none.
bridge_neighbors_kernel = Kernel('neighbours', _bridge_neighbors_twin,
                                 _neighbors_on_card, differentiable=(0,))


def bridge_neighbors(pressure, valid):
    """Previous/next valid pressure of every level (exclusive cumulative
    min/max scans along the level axis; pressures sorted decreasing).
    ``+inf``/``-inf`` mark "no previous"/"no next"; a NaN pressure under
    a True ``valid`` runs on through the previous and back through the
    next, as ``torch.cummin``/``torch.cummax`` carry it.  Through
    :data:`bridge_neighbors_kernel`."""
    with span('xparcel.prep.neighbors'):
        return bridge_neighbors_kernel(pressure, valid)


def _layer_anchors(p, valid, topb, j, neighbors=None):
    """What :func:`mixed_layer` integrates over, for one valid-level set:
    the in-layer mask; the last valid in-layer level (mask, pressure,
    whether there is one); each in-layer level's previous and next valid
    pressure (its own where there is none, or the next lies below the
    layer top); and the first valid in-layer pressure (0 if none)."""
    prev_raw, next_raw = (bridge_neighbors(p, valid) if neighbors is None
                          else neighbors)
    m = valid & (p >= topb)
    k_star = torch.where(m, j, -1).amax(-1)
    at_k = (j == k_star[..., None]) & m
    p_k = torch.where(at_k, p, 0.0).sum(-1)
    p_own = torch.where(m, p, 0.0)
    prev_p = torch.where(m & torch.isfinite(prev_raw), prev_raw, p_own)
    next_p = torch.where(m & (next_raw >= topb), next_raw, p_own)
    return m, at_k, p_k, at_k.any(-1), prev_p, next_p, p_own.amax(-1)


def mixed_layer(fields, depth=100.0, valid=None, neighbors=None):
    """Mass-weighted average of each variable over the surface-based layer
    of ``depth`` hPa.

    Trapezoids between consecutive valid in-layer levels (interior-NaN runs
    bridged), plus a boundary gap from the last valid in-layer level to the
    log-interpolated layer top, divided by the span the integral covers.
    With ``prev``/``next`` the neighbouring valid pressures of each level,
    the bridged trapezoid sum telescopes to
    ``0.5 * sum_i v_i * (prev_i - next_i)``.

    ``valid``: a level mask shared by every variable (then ``neighbors``
    may pass its precomputed :func:`bridge_neighbors`); None, each
    variable mixes over its own valid levels.
    """
    p = fields['pressure']
    vals = {k: v for k, v in fields.items() if k != 'pressure'}
    bottom = nanmax(p)
    top = bottom - depth
    topb = top[..., None]
    j = torch.arange(p.shape[-1], device=p.device)

    safe_top = torch.where(torch.isnan(top), 0.0, top)
    safe_bottom = torch.where(torch.isnan(bottom), 0.0, bottom)

    shared = valid is not None
    if shared:
        valid = valid & notnan(p)
        anchors = _layer_anchors(p, valid, topb, j, neighbors)
        f_top = interp_many(vals, torch.where(valid, p, torch.nan), top,
                            log=True)
    out = {}
    for k, v in vals.items():
        if shared:
            ft = f_top[k]
        else:
            vv = notnan(p) & notnan(v)
            anchors = _layer_anchors(p, vv, topb, j)
            ft = interp_many({k: v}, torch.where(vv, p, torch.nan), top,
                             log=True)[k]
        m, at_k, p_k, any_k, prev_p, next_p, p_first = anchors
        v_own = torch.where(m, v, 0.0)
        inner = 0.5 * (v_own * (prev_p - next_p)).sum(-1)
        f_k = torch.where(at_k, v, 0.0).sum(-1)
        b_ok = any_k & notnan(ft)
        b_area = (0.5 * (f_k + torch.where(b_ok, ft, 0.0))
                  * torch.abs(p_k - safe_top))
        span = torch.where(b_ok,
                           torch.where(p_first == safe_bottom,
                                       torch.full_like(p_first, depth),
                                       p_first - safe_top),
                           p_first - p_k)
        inv = torch.where(any_k & (span > 0),
                          1.0 / torch.where(span > 0, span, 1.0), torch.nan)
        out[k] = (inner + torch.where(b_ok, b_area, 0.0)) * inv
    return out


def conserved_fields(pressure, temperature, dewpoint):
    """The mixing-conserved per-level fields (theta, mixing ratio), shared
    when mixing several depths of the same columns."""
    with span('xparcel.prep.conserved'):
        return {'theta': thermo.potential_temperature(pressure, temperature),
                'mixing_ratio': thermo.saturation_mixing_ratio(pressure,
                                                               dewpoint)}


def mixed_parcel(pressure, temperature, dewpoint, depth=100.0,
                 conserved=None, neighbors=None):
    """Fully mix a surface-based layer, conserving theta and mixing ratio;
    returns the parcel's pressure/temperature/dewpoint.  The parcel starts
    at the first valid pressure."""
    parcel_start_pressure = nanmax(pressure)
    valid = notnan(pressure) & notnan(temperature) & notnan(dewpoint)
    if conserved is None:
        conserved = conserved_fields(pressure, temperature, dewpoint)
    mixed = mixed_layer({'pressure': pressure, **conserved}, depth, valid,
                        neighbors=neighbors)
    temp = mixed['theta'] * thermo.exner_function(parcel_start_pressure)
    vap = thermo.vapor_pressure(parcel_start_pressure, mixed['mixing_ratio'])
    return {'pressure': parcel_start_pressure, 'temperature': temp,
            'dewpoint': thermo.dewpoint(vap)}


def most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0):
    """The max-theta-e parcel in the surface-based layer of ``depth`` hPa;
    ties take the first (lowest) level."""
    layer = get_layer({'pressure': pressure, 'temperature': temperature,
                       'dewpoint': dewpoint}, depth=depth, interpolate=False)
    eq = thermo.equivalent_potential_temperature(
        layer['pressure'], layer['temperature'], layer['dewpoint'])
    max_eq = nanmax(eq)
    k = torch.argmax((eq == max_eq[..., None]).to(torch.uint8), dim=-1)
    sel = ((torch.arange(eq.shape[-1], device=eq.device) == k[..., None]) &
           notnan(max_eq)[..., None])
    return {k_: nanmax(v, where=sel) for k_, v in layer.items()}


def _most_unstable_twin(pressure, temperature, dewpoint, depth=300.0):
    """:func:`from_most_unstable_parcel` as plain torch ops (the kernel's
    twin): :func:`most_unstable_parcel`, then every level below the parcel
    NaN.  Returns the field pressure, temperature and dewpoint, each in
    the shape the three inputs broadcast to, then the parcel's."""
    parcel = most_unstable_parcel(pressure, temperature, dewpoint,
                                  depth=depth)
    keep = pressure <= parcel['pressure'][..., None]
    return (torch.where(keep, pressure, torch.nan),
            torch.where(keep, temperature, torch.nan),
            torch.where(keep, dewpoint, torch.nan),
            parcel['pressure'], parcel['temperature'], parcel['dewpoint'])


def _most_unstable_on_card(launch, pressure, temperature, dewpoint,
                           depth=300.0):
    """:data:`most_unstable_kernel` on CUDA tensors: one launch of the
    library's ``most_unstable_<dtype>``."""
    shape = temperature.shape
    _check_columns(pressure, temperature, dewpoint)
    # One allocation for the fields and one for the parcel.
    fields = torch.empty((3, *shape), dtype=temperature.dtype,
                         device=temperature.device)
    parcel = torch.empty((3, *shape[:-1]), dtype=temperature.dtype,
                         device=temperature.device)
    depths = None
    if torch.is_tensor(depth) and depth.numel() != 1:
        # A depth a column, read as a (B,) vector.
        depths = depth.expand(shape[:-1]).reshape(-1).contiguous()
        depth = 0.0
    if fields.numel() > 0:
        rows, t, td, row_stride = _column_rows(pressure, temperature,
                                               dewpoint)
        B, L = rows.shape
        launch('most_unstable', [rows.data_ptr(), t.data_ptr(),
                                 td.data_ptr(),
                                 None if depths is None else depths.data_ptr(),
                                 fields.data_ptr(), parcel.data_ptr()],
               B, L, row_stride, float(depth))
    return (*fields, *parcel)


#: :func:`from_most_unstable_parcel` as one kernel call: (pressure,
#: temperature, dewpoint, depth) to the flat tuple of
#: :func:`_most_unstable_twin`.  CUDA tensors go to the hand-written
#: kernel (``most_unstable_kernel.launches`` counts each launch, one a
#: call): float32 or float64, temperature and dewpoint of one shape of
#: one level or more, the pressure broadcasting to it, read in place where
#: its rows are one row or contiguous (else copied); the depth a number or
#: a tensor of their dtype that broadcasts to the columns (a depth a
#: column).  On either device every field takes the full shape.  Rows of
#: any width: one too long for a block's shared memory (some 18,000 levels
#: in float32, 9,000 in float64) is read in place.  CPU tensors go to the
#: plain twin.  The three fields take a gradient, through the twin's VJP.
most_unstable_kernel = Kernel('most-unstable', _most_unstable_twin,
                              _most_unstable_on_card,
                              differentiable=(0, 1, 2))


def _unflatten(out):
    """(fields dict, parcel dict) of a flat (p, t, td, parcel p, t, td)."""
    keys = ('pressure', 'temperature', 'dewpoint')
    return dict(zip(keys, out[:3])), dict(zip(keys, out[3:6]))


def _card_inputs(pressure, temperature, dewpoint, depth):
    """:func:`from_most_unstable_parcel`'s CUDA inputs as
    :data:`most_unstable_kernel` takes them, where the plain ops take them
    too: pressure, temperature and dewpoint in one dtype (the three's
    promoted one, float32 at least), the last two expanded to the shape
    all three broadcast to (views); a one-element depth as a number, a
    longer one in that dtype on their device."""
    dtype = torch.promote_types(
        torch.promote_types(pressure.dtype, temperature.dtype),
        dewpoint.dtype)
    dtype = torch.float64 if dtype == torch.float64 else torch.float32
    shape = torch.broadcast_shapes(pressure.shape, temperature.shape,
                                   dewpoint.shape)
    if torch.is_tensor(depth):
        depth = (float(depth) if depth.numel() == 1
                 else depth.to(pressure.device, dtype))
    return (pressure.to(dtype), temperature.to(dtype).expand(shape),
            dewpoint.to(dtype).expand(shape), depth)


def from_most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0):
    """Mask every column below its most unstable parcel.  Returns (fields
    dict of NaN-prefixed (…, L) columns, parcel dict).  Through
    :data:`most_unstable_kernel`; on CUDA tensors with the inputs made
    what it takes (:func:`_card_inputs`) and each output back in the dtype
    of its input, as the plain ops give it."""
    with span('xparcel.prep.most_unstable'):
        if not pressure.is_cuda:
            return _unflatten(most_unstable_kernel(pressure, temperature,
                                                   dewpoint, depth))
        out = most_unstable_kernel(*_card_inputs(pressure, temperature,
                                                 dewpoint, depth))
        dtypes = [x.dtype for x in (pressure, temperature, dewpoint)] * 2
        return _unflatten(tuple(o.to(d) for o, d in zip(out, dtypes)))


def mix_layer(pressure, temperature, dewpoint, depth=100.0, conserved=None,
              neighbors=None, grow=True):
    """Replace the lowest ``depth`` hPa with the fully mixed parcel.

    Returns (fields dict, parcel dict): a NaN prefix over the mixed-away
    levels, then the parcel, then the kept levels.  With ``grow`` the
    parcel is spliced in by ``insert_level`` (L+1 levels out).  Without,
    it is written into the last mixed-away slot of the L levels, right
    below the first kept level (with nothing kept, slot 0): the same
    profile with one NaN less in its prefix, and no splice (the fused
    pipelines' path).
    """
    with span('xparcel.prep.mix_layer'):
        return _mix_layer(pressure, temperature, dewpoint, depth, conserved,
                          neighbors, grow)


def _mix_layer(pressure, temperature, dewpoint, depth, conserved, neighbors,
               grow):
    """:func:`mix_layer` outside its span."""
    mp = mixed_parcel(pressure, temperature, dewpoint, depth=depth,
                      conserved=conserved, neighbors=neighbors)
    keep = pressure < (nanmax(pressure) - depth)[..., None]
    masked = {
        'pressure': torch.where(keep, pressure, torch.nan),
        'temperature': torch.where(keep, temperature, torch.nan),
        'dewpoint': torch.where(keep, dewpoint, torch.nan),
    }
    if grow:
        return insert_level(masked, mp), mp
    kept = notnan(masked['pressure'])
    first_kept = torch.argmax(kept.to(torch.uint8), dim=-1)
    slot = torch.where(kept.any(-1), first_kept - 1, 0)[..., None]
    at = torch.arange(pressure.shape[-1], device=pressure.device) == slot
    out = {k: torch.where(at, mp[k][..., None], masked[k])
           for k in masked}
    return out, mp


def _mix_layers_twin(pressure, temperature, dewpoint, depths):
    """:func:`mix_layers` as plain torch ops (the kernel's twin): the
    conserved fields and the neighbour scans of the shared level mask, then
    ``mix_layer(grow=False)``'s body at each depth (inside the one span of
    :func:`mix_layers`).  Returns, depth after depth, the field pressure,
    temperature and dewpoint, then the parcel's, each in the full shape: a
    pressure that broadcasts to the temperature's is taken as its broadcast
    view, as the kernel reads it."""
    _check_depths(depths)
    pressure = pressure.expand(temperature.shape)
    conserved = conserved_fields(pressure, temperature, dewpoint)
    neighbors = bridge_neighbors(pressure, ~(torch.isnan(pressure) |
                                             torch.isnan(temperature) |
                                             torch.isnan(dewpoint)))
    out = ()
    for depth in depths:
        fields, parcel = _mix_layer(pressure, temperature, dewpoint, depth,
                                    conserved, neighbors, grow=False)
        out += (*fields.values(), *parcel.values())
    return out


def _check_depths(depths):
    """One or two depths: what one launch of ``csrc/mix_layer.cu`` takes
    (its ``kMaxDepths``), and all that the fused pipelines ask for."""
    if not 1 <= len(depths) <= 2:
        raise ValueError(f'mix_layers takes one or two depths, not '
                         f'{len(depths)}')


def _check_columns(pressure, temperature, dewpoint):
    """Raise ``ValueError`` unless temperature and dewpoint share a shape
    of one level or more that the pressure broadcasts to: what the column
    kernels (``csrc/mix_layer.cu``, ``csrc/most_unstable.cu``) take."""
    shape = temperature.shape
    if (temperature.dim() == 0 or dewpoint.shape != shape
            or pressure.dim() == 0 or pressure.dim() > len(shape)
            or pressure.shape[-1] != shape[-1]
            or any(s not in (1, v) for s, v in zip(pressure.shape[::-1],
                                                   shape[::-1]))):
        raise ValueError(f'pressure {tuple(pressure.shape)}, temperature '
                         f'{tuple(shape)} and dewpoint '
                         f'{tuple(dewpoint.shape)}: the last two must share '
                         f'a shape that the pressure broadcasts to')
    if shape[-1] == 0:
        raise ValueError('a column kernel takes one level or more')


def _column_rows(pressure, temperature, dewpoint):
    """The non-empty inputs of a column kernel as it reads them, B rows of
    L levels: ``(rows, t, td, row_stride)``, the pressure as
    :func:`_kernel_rows` gives it, t and td contiguous."""
    rows, row_stride = _kernel_rows(pressure, temperature.shape)
    B, L = rows.shape
    return (rows, temperature.reshape(B, L).contiguous(),
            dewpoint.reshape(B, L).contiguous(), row_stride)


def _mix_layers_on_card(launch, pressure, temperature, dewpoint, depths):
    """:data:`mix_layers_kernel` on CUDA tensors: one launch of the
    library's ``mix_layers_<dtype>``."""
    shape = temperature.shape
    _check_depths(depths)
    _check_columns(pressure, temperature, dewpoint)
    D = len(depths)
    # One allocation for the fields and one for the parcels of every depth.
    fields = torch.empty((D, 3, *shape), dtype=temperature.dtype,
                         device=temperature.device)
    parcel = torch.empty((D, 3, *shape[:-1]), dtype=temperature.dtype,
                         device=temperature.device)
    if fields.numel() > 0:
        rows, t, td, row_stride = _column_rows(pressure, temperature,
                                               dewpoint)
        B, L = rows.shape
        ds = [float(d) for d in depths]
        launch('mix_layers', [rows.data_ptr(), t.data_ptr(), td.data_ptr(),
                              fields.data_ptr(), parcel.data_ptr()],
               B, L, row_stride, D, *ds, *[0.0] * (2 - D))
    return tuple(x for f, c in zip(fields, parcel) for x in (*f, *c))


#: :func:`mix_layers` as one kernel call: (pressure, temperature, dewpoint,
#: depths) to the flat tuple of :func:`_mix_layers_twin`; one or two
#: depths.  CUDA tensors go to the hand-written kernel
#: (``mix_layers_kernel.launches`` counts each launch, one a call):
#: float32 or float64, temperature and dewpoint of one shape of one level
#: or more, the pressure broadcasting to it, read in place where its rows
#: are one row or contiguous (else copied).  On either device every output
#: takes the full shape.  A row's levels must fit one block's shared
#: memory: some 13,000 in float32, 7,000 in float64.  CPU tensors go to the
#: plain twin.  The three fields take a gradient, through the twin's VJP.
mix_layers_kernel = Kernel('mixed-layer', _mix_layers_twin,
                           _mix_layers_on_card, differentiable=(0, 1, 2))


def mix_layers(pressure, temperature, dewpoint, depths):
    """``mix_layer(pressure, temperature, dewpoint, depth=d, grow=False)``
    for each depth ``d`` (hPa) of the sequence ``depths`` (one or two),
    with the conserved fields and the neighbour scans over the levels where
    all three inputs hold a number computed once for all: a list of
    (fields, parcel) dict pairs, one a depth, each field of the
    temperature's shape (a 1-D pressure's values broadcast).  Through
    :data:`mix_layers_kernel`."""
    with span('xparcel.prep.mix_layer'):
        out = mix_layers_kernel(pressure, temperature, dewpoint,
                                tuple(depths))
    return [_unflatten(out[i:i + 6]) for i in range(0, len(out), 6)]


def most_unstable_cape_cin(pressure, temperature, dewpoint, depth=300.0,
                           **kwargs):
    """CAPE/CIN of the most-unstable parcel in the lowest ``depth`` hPa,
    on the columns masked below it; ``kwargs`` as for
    :func:`cape.cape_cin`.  Returns (cape/cin dict, profile dict, parcel
    dict)."""
    fields, parcel = from_most_unstable_parcel(pressure, temperature,
                                               dewpoint, depth=depth)
    res, profile = cape_cin(fields['pressure'], fields['temperature'],
                            fields['dewpoint'],
                            parcel_temperature=parcel['temperature'],
                            parcel_pressure=parcel['pressure'],
                            parcel_dewpoint=parcel['dewpoint'], **kwargs)
    return res, profile, parcel


def mixed_layer_cape_cin(pressure, temperature, dewpoint, depth=100.0,
                         conserved=None, neighbors=None, **kwargs):
    """CAPE/CIN of the fully mixed lowest ``depth`` hPa, spliced in as the
    new bottom level (``mix_layer(grow=True)``); ``kwargs`` as for
    :func:`cape.cape_cin`.  Returns (cape/cin dict, profile dict, parcel
    dict)."""
    fields, mp = mix_layer(pressure, temperature, dewpoint, depth=depth,
                           conserved=conserved, neighbors=neighbors)
    res, profile = cape_cin(fields['pressure'], fields['temperature'],
                            fields['dewpoint'],
                            parcel_temperature=mp['temperature'],
                            parcel_pressure=mp['pressure'],
                            parcel_dewpoint=mp['dewpoint'], **kwargs)
    return res, profile, mp
