"""Device kernels per call: the kernels in the traced window over the
calls traced.  Counts the launches that bound the pipeline and its
pre-pass."""


def read(trace):
    lo, hi = trace.window
    n = sum(1 for a, b, _ in trace.kernels if a >= lo and b <= hi)
    return n / len(trace.calls) if trace.calls and n else None
