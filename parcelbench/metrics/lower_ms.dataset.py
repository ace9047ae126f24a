"""Milliseconds a call in which the host lowers the Dataset: the summed
duration of the traced window's ``xparcel.dataset.lower`` spans (the
native repacks of ``xarray_api.from_dataset``) over the calls traced.
None where the program records no such span."""

SPAN = 'xparcel.dataset.lower'


def read(trace):
    lo, hi = trace.window
    hits = [b - a for a, b, name in trace.host
            if name == SPAN and a >= lo and b <= hi]
    if not hits or not trace.calls:
        return None
    return sum(hits) * 1e-3 / len(trace.calls)
