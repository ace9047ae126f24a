"""Kernel launches a call from inside the parcel preps and the pre-pass:
the traced window's ``cudaLaunchKernel*`` runtime calls that start inside
the union of the program's ``xparcel.prep.*`` spans, over the calls
traced.  A launch inside nested prep spans counts once.  None where the
program records no prep span."""

import bisect

PREFIX = 'xparcel.prep.'
LAUNCH = 'cudaLaunchKernel'


def prep_union(trace):
    """The union of the window's prep spans, as sorted disjoint
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
    spans = prep_union(trace)
    if not spans or not trace.calls:
        return None
    starts = [a for a, _ in spans]
    n = 0
    for a, _, name in trace.host:
        if name.startswith(LAUNCH):
            i = bisect.bisect_right(starts, a) - 1
            n += i >= 0 and a < spans[i][1]
    return n / len(trace.calls)
