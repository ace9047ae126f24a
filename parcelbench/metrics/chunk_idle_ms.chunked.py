"""Milliseconds a call in which the card sits idle while the host slices
the next chunk or gathers the chunks' outputs in ``parallel.chunked``: the
card's idle intervals in the traced window (no kernel, memcpy or memset)
that overlap the union of the program's ``xparcel.chunked.*`` spans, over
the calls traced.  Time under overlapping spans counts once.  None where
the program records no such span."""

PREFIX = 'xparcel.chunked.'


def span_union(trace):
    """The union of the window's chunked spans, as sorted disjoint
    [start, end] intervals."""
    lo, hi = trace.window
    merged = []
    for a, b, name in trace.host:           # sorted by start
        if not name.startswith(PREFIX) or a < lo or b > hi:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(trace):
    spans = span_union(trace)
    if not spans or not trace.calls:
        return None
    idle, i = 0.0, 0
    for a, b in trace.gaps():               # sorted and disjoint
        while i < len(spans) and spans[i][1] <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < b:
            idle += min(b, spans[j][1]) - max(a, spans[j][0])
            j += 1
    return idle * 1e-3 / len(trace.calls)
