"""The diagnostics-tail kernel's share of its roofline, in %.

Numerator: the least time the card could take for the traced calls'
tails, one a call.  Counted from the cell's shapes and its inputs' valid
levels: the four (B, L) fields (pressure, temperature, dewpoint, height)
read once, the six (B,) outputs (t850, td850, 700-500 hPa lapse rate,
t500, freezing and melting level) written once, and about 30 operations
per valid level (its log, three anchor updates, the wet bulb and two
crossings).  Denominator: the summed duration of the traced kernels
matching ``PATTERNS``.
"""

from parcelbench.harness.card import least_seconds

PATTERNS = ('diag_tail_kernel',)
OUTPUTS = 6


def work(columns, levels, valid_levels, itemsize):
    """(bytes, operations) of one tail."""
    nbytes = itemsize * (4 * columns * levels + OUTPUTS * columns)
    return nbytes, 30 * valid_levels


def read(trace):
    seconds, n = trace.kernel_seconds(PATTERNS)
    if not n:
        return None
    least = sum(least_seconds(*work(**c), c['itemsize'])
                for c in trace.calls)
    return 100.0 * least / seconds
