"""Milliseconds a call in which the host lifts the outputs to a Dataset:
the summed duration of the traced window's ``xparcel.dataset.lift`` spans
(``xarray_api.to_dataset``) over the calls traced.  None where the
program records no such span."""

SPAN = 'xparcel.dataset.lift'


def read(trace):
    lo, hi = trace.window
    hits = [b - a for a, b, name in trace.host
            if name == SPAN and a >= lo and b <= hi]
    if not hits or not trace.calls:
        return None
    return sum(hits) * 1e-3 / len(trace.calls)
