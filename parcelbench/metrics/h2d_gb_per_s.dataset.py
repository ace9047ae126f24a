"""Host-to-device copy rate in GB/s: the bytes of the traced window's
HtoD memcpys over their summed device time.  None without such copies."""


def read(trace):
    lo, hi = trace.window
    hits = [(b - a, n) for a, b, name, n in trace.copies
            if 'HtoD' in name and a >= lo and b <= hi]
    seconds = sum(d for d, _ in hits) * 1e-6
    if not hits or seconds <= 0:
        return None
    return sum(n for _, n in hits) / seconds / 1e9
