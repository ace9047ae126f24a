"""The traced window: ``torch.profiler`` over a few timed calls, read back
as device intervals, copies and host spans.

The trace is written under ``TMPDIR`` as a Chrome trace, read and deleted.
Each timed call sits in a ``parcelbench.call`` span of the harness's own;
the traced window runs from the first such span's start to the last one's
end.  Metric readers (``metrics/<name>.py``) take the :class:`Trace`.
"""

import bisect
import json
import os
import tempfile

CALL_SPAN = 'parcelbench.call'
HOST_CATEGORIES = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


class Trace:
    """Intervals in microseconds on the trace's clock.

    ``kernels``: (start, end, name); ``copies``: (start, end, name,
    bytes), memcpy and memset; ``host``: (start, end, name) host spans;
    ``window``: (start, end); ``calls``: the traced calls' work, one dict
    each (``columns``, ``levels``, ``valid_levels``, ``itemsize``)."""

    def __init__(self, kernels, copies, host, window, calls):
        self.kernels, self.copies = kernels, copies
        self.host = sorted(host)
        self._host_starts = [a for a, _, _ in self.host]
        self.window, self.calls = window, calls

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    def device_intervals(self):
        """Kernel, memcpy and memset intervals clipped to the window."""
        lo, hi = self.window
        out = []
        for iv in list(self.kernels) + list(self.copies):
            a, b = max(iv[0], lo), min(iv[1], hi)
            if b > a:
                out.append((a, b))
        return out

    def busy_union(self):
        """The union of the device intervals, as sorted disjoint
        intervals."""
        merged = []
        for a, b in sorted(self.device_intervals()):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self):
        return sum(b - a for a, b in self.busy_union()) * 1e-6

    def idle_share(self):
        """1 - the device's busy union over the window (None for an empty
        window or a trace without device work)."""
        if self.window_s <= 0 or not self.device_intervals():
            return None
        return 1.0 - self.busy_s() / self.window_s

    def kernel_seconds(self, patterns):
        """Summed duration of the window's kernels whose names contain one
        of ``patterns``, and how many there were."""
        lo, hi = self.window
        hits = [b - a for a, b, name in self.kernels
                if a >= lo and b <= hi and any(p in name for p in patterns)]
        return sum(hits) * 1e-6, len(hits)

    def gaps(self):
        """Idle intervals of the device within the window."""
        lo, hi = self.window
        out, cursor = [], lo
        for a, b in self.busy_union():
            if a > cursor:
                out.append((cursor, a))
            cursor = max(cursor, b)
        if hi > cursor:
            out.append((cursor, hi))
        return out

    def host_label(self, t, lookback=64):
        """What the host was doing at ``t``: the latest-started of the
        ``lookback`` host spans begun last before ``t`` that covers it;
        else the host was between operations (Python, the harness)."""
        i = bisect.bisect_right(self._host_starts, t)
        for a, b, name in reversed(self.host[max(0, i - lookback):i]):
            if b >= t and name != CALL_SPAN:
                return name
        return 'host between operations'

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time by
        what the host was doing, each as at most ``top`` [name, seconds]."""
        lo, hi = self.window
        ops = {}
        for iv in list(self.kernels) + list(self.copies):
            if iv[0] >= lo and iv[1] <= hi:
                ops[iv[2]] = ops.get(iv[2], 0.0) + (iv[1] - iv[0]) * 1e-6
        idle = {}
        for a, b in self.gaps():
            label = self.host_label(0.5 * (a + b))
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
        ranked = [sorted(d.items(), key=lambda kv: -kv[1])[:top]
                  for d in (ops, idle)]
        return {'device_ops': [[k[:160], v] for k, v in ranked[0]],
                'idle_gaps': [[k[:160], v] for k, v in ranked[1]]}


def parse(events, calls):
    """A :class:`Trace` from Chrome-trace events."""
    kernels, copies, host, spans = [], [], [], []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        cat = str(ev.get('cat', '')).lower()
        a = float(ev['ts'])
        b = a + float(ev['dur'])
        name = str(ev.get('name', ''))
        if cat == 'kernel':
            kernels.append((a, b, name))
        elif cat in ('gpu_memcpy', 'gpu_memset'):
            nbytes = (ev.get('args') or {}).get('bytes', 0)
            copies.append((a, b, name, float(nbytes)))
        elif cat in HOST_CATEGORIES:
            host.append((a, b, name))
            if name == CALL_SPAN:
                spans.append((a, b))
    if not spans:
        raise RuntimeError(f'the trace holds no {CALL_SPAN} span')
    window = (min(a for a, _ in spans), max(b for _, b in spans))
    return Trace(kernels, copies, host, window, calls)


class Profiler:
    """``torch.profiler`` on the host and the card, started and stopped by
    hand around the traced calls."""

    def __init__(self):
        import torch
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])

    def start(self):
        self._prof.__enter__()

    def stop(self, calls):
        """Stop, write the trace under ``TMPDIR``, read it back, delete it
        and return the :class:`Trace`."""
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix='parcelbench_', suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.remove(path)
        return parse(events, calls)


def call_span():
    """The harness's span around one timed call."""
    import torch
    return torch.profiler.record_function(CALL_SPAN)
