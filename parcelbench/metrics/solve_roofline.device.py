"""The CAPE/CIN solve kernel's share of its roofline, in %.

Numerator: the least time the card could take for the traced calls'
solves, three a call (most-unstable, mixed-100, mixed-50).  Counted from
the cell's shapes and its inputs' valid levels, never from what
implements the solve: per solve, the three (B, L) profile fields
(pressure, temperature, dewpoint) and the (B,) parcel's three values read
once, the seven (B,) outputs (CAPE, CIN, LFC and EL pressure and
temperature, lifted index) written once, and the spectral table (14,300
curves x 42 coefficients) read once; per column, one evaluated slot for
each valid level and one for the LCL, each the Clenshaw series of a
14-term segment (3 operations a term) and 70 more (the log, four exp,
five divides, the arithmetic around them and the slot's gap).
Denominator: the summed duration of the traced kernels matching
``PATTERNS``.  The power limit is printed beside it.
"""

from parcelbench.harness.card import least_seconds

PATTERNS = ('fused_cape_cin_kernel',)
SOLVES_PER_CALL = 3
OUTPUTS = 7
TABLE_VALUES = 14300 * 42
SEGMENT_TERMS = 14


def work(columns, levels, valid_levels, itemsize):
    """(bytes, operations) of one solve."""
    nbytes = itemsize * (3 * columns * levels + 3 * columns
                         + OUTPUTS * columns + TABLE_VALUES)
    ops = (valid_levels + columns) * (3 * SEGMENT_TERMS + 70)
    return nbytes, ops


def read(trace):
    seconds, n = trace.kernel_seconds(PATTERNS)
    if not n:
        return None
    least = sum(SOLVES_PER_CALL * least_seconds(*work(**c),
                                                c['itemsize'])
                for c in trace.calls)
    return 100.0 * least / seconds
