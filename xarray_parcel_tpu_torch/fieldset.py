"""Output metadata: the reference's xarray-attrs layer.

Port of ``xarray_parcel_tpu.fieldset``.  The reference attaches
``long_name``/``units``/``description`` attrs to every output variable.
Tensors carry no attrs, so the metadata lives in a registry keyed by
variable name; ``annotate`` wraps a result dict in a ``FieldSet`` exposing
``.attrs``.  A FieldSet is a plain dict subclass: it passes through any
code that takes a dict of tensors.
"""

import re


class FieldSet(dict):
    """A dict of named tensors with attribute access and per-variable
    attrs.

    ``_attr_overrides``: optional {name: description} texts that take
    precedence over the registry (the reference's ``description=``
    parameters on lifted_index/DCI).
    """

    def __init__(self, *args, _attr_overrides=None, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, '_overrides', dict(_attr_overrides or {}))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @property
    def attrs(self):
        out = {}
        for k in self:
            a = attrs_for(k)
            if k in getattr(self, '_overrides', {}):
                a['description'] = self._overrides[k]
            out[k] = a
        return out


_BASE_ATTRS = {
    'cape': {'long_name': 'Convective available potential energy',
             'units': 'J kg$^{-1}$'},
    'cin': {'long_name': 'Convective inhibition', 'units': 'J kg$^{-1}$'},
    'lifted_index': {'long_name': 'Lifted index', 'units': 'K'},
    'dci': {'long_name': 'Deep convective index', 'units': 'C'},
    'mixing_ratio': {'long_name': 'Mixing ratio', 'units': 'kg kg$^{-1}$'},
    'lcl_pressure': {'long_name': 'Lifting condensation level pressure',
                     'units': 'hPa'},
    'lcl_temperature': {'long_name': 'Lifting condensation level temperature',
                        'units': 'K'},
    'lcl_virtual_temperature': {
        'long_name': 'Lifting condensation level virtual temperature',
        'units': 'K'},
    'lfc_pressure': {'long_name': 'Level of free convection pressure',
                     'units': 'hPa'},
    'lfc_temperature': {'long_name': 'Level of free convection temperature',
                        'units': 'K'},
    'el_pressure': {'long_name': 'Equilibrium level pressure', 'units': 'hPa'},
    'el_temperature': {'long_name': 'Equilibrium level temperature',
                       'units': 'K'},
    'pressure': {'long_name': 'Pressure', 'units': 'hPa'},
    'temperature': {'long_name': 'Temperature', 'units': 'K'},
    'virtual_temperature': {'long_name': 'Virtual temperature', 'units': 'K'},
    'dewpoint': {'long_name': 'Dewpoint', 'units': 'K'},
    'environment_temperature': {'long_name': 'Environment temperature',
                                'units': 'K'},
    'environment_virtual_temperature': {
        'long_name': 'Environment virtual temperature', 'units': 'K'},
    'environment_dewpoint': {'long_name': 'Environment dewpoint',
                             'units': 'K'},
    'lapse_rate_700_500': {'long_name': 'Lapse rate',
                           'description': '700-500 hPa lapse rate',
                           'units': 'K km$^{-1}$'},
    'temp_500': {'long_name': 'Isobar temperature',
                 'description': 'Temperature at 500 hPa.', 'units': 'K'},
    'freezing_level': {
        'long_name': 'Freezing-level height',
        'description': 'Height of zero degree dry-bulb temperature isotherm.',
        'units': 'm'},
    'melting_level': {
        'long_name': 'Melting-level height',
        'description': 'Height of zero degree wet-bulb temperature isotherm.',
        'units': 'm'},
    'wet_bulb_temperature': {'long_name': 'Wet bulb temperature',
                             'units': 'K'},
    'shear_u': {'long_name': 'Surface to 6000 m wind shear, U component.',
                'units': 'm s$^{-1}$'},
    'shear_v': {'long_name': 'Surface to 6000 m wind shear, V component.',
                'units': 'm s$^{-1}$'},
    'shear_magnitude': {'long_name': 'Surface to 6000 m bulk wind shear.',
                        'units': 'm s$^{-1}$'},
    'positive_shear': {'long_name': 'True if 6000 m wind > surface wind.'},
    'ship': {'long_name': 'Significant hail parameter (SHIP)',
             'units': 'J kg$^{-2}$ g K$^2$ km$^{-1}$ m s$^{-1}$'},
}

_PREFIX_DESCRIPTIONS = {
    'mu': 'most-unstable parcel in lowest 250 hPa',
    'mixed_100': 'fully-mixed lowest 100 hPa parcel',
    'mixed_50': 'fully-mixed lowest 50 hPa parcel',
}

_PROXY_STUDIES = {
    'proxy_Craven2004': 'Craven 2004', 'proxy_Kunz2007': 'Kunz 2007',
    'proxy_Trapp2007': 'Trapp 2007', 'proxy_Marsh2009': 'Marsh 2009',
    'proxy_Allen2011': 'Allen 2011', 'proxy_Allen2014': 'Allen 2014',
    'proxy_Eccel2012': 'Eccel 2012', 'proxy_Mohr2013': 'Mohr 2013',
    'proxy_SHIP_0.1': 'SHIP > 0.1',
}


def _base_attrs(name):
    """Attrs of an unprefixed variable name: a registry entry, a proxy, or
    a parameterised diagnostic (``temp_850``, ``lapse_rate_850_700``),
    whose description names the pressures actually used.  None if the name
    is none of these."""
    if name in _BASE_ATTRS:
        return dict(_BASE_ATTRS[name])
    if name in _PROXY_STUDIES:
        return {'long_name': 'Proxy ' + _PROXY_STUDIES[name]}
    m = re.fullmatch(r'temp_([0-9][0-9.]*)', name)
    if m:
        base = dict(_BASE_ATTRS['temp_500'])
        base['description'] = f'Temperature at {m.group(1)} hPa.'
        return base
    m = re.fullmatch(r'lapse_rate_([0-9][0-9.]*)_([0-9][0-9.]*)', name)
    if m:
        base = dict(_BASE_ATTRS['lapse_rate_700_500'])
        base['description'] = f'{m.group(1)}-{m.group(2)} hPa lapse rate'
        return base
    return None


def attrs_for(name):
    """Canonical attrs for a variable name, resolving prefixes like
    ``mu_cape``, ``mixed_100_lifted_index`` or ``mu_temp_850`` (a known
    prefix before a parameterised name).  An unknown name gives ``{}``."""
    base = _base_attrs(name)
    if base is not None:
        return base
    for prefix, desc in _PREFIX_DESCRIPTIONS.items():
        tag = prefix + '_'
        if name.startswith(tag):
            rest = name[len(tag):]
            base = _base_attrs(rest)
            if base is not None:
                # A parameterised name keeps its pressures in the text.
                what = (base.get('long_name', name) if rest in _BASE_ATTRS
                        else base['description'].rstrip('.'))
                base['description'] = f'{what} for {desc}.'
                return base
    # An unknown prefix keeps the base variable's attrs: the reference
    # renames after attaching long_name/units, so ``prefix='sb'`` outputs
    # stay annotated.
    parts = name.split('_')
    for i in range(1, len(parts)):
        base = _base_attrs('_'.join(parts[i:]))
        if base is not None:
            return base
    return {}


def annotate(result, descriptions=None):
    """Wrap a result dict in a FieldSet (attrs resolve lazily by name);
    ``descriptions``: optional {name: text} overrides."""
    return FieldSet(result, _attr_overrides=descriptions)
