"""One run of one cell: set-up, warm-up, the measured window, the traced
calls, the check against the reference, and the result line.

Set-up makes both time steps' inputs from the seed, loads the program's
tables from the checkout's cache and warms the cell's own call once per
time step.  The window then calls the program in turn on the two time
steps for ``seconds``; every call is synchronised and timed alone, and the
rate is taken over all the calls and all the time of the window.  A
reservoir per time step, drawn from the seed, keeps the outputs of one
call of each time step at ``SAMPLE_COLUMNS`` columns also drawn from the
seed; once the window has closed and the program's inputs are freed, the
reference works those columns out again from the same inputs.  With
``trace``, ``trace_calls`` more calls run under ``torch.profiler`` after
the warm-up and before the window, which is the same in both kinds of
run, and the result carries the per-layer metrics instead of the
end-to-end ones.
"""

import random
import sys
import time

import numpy as np
import torch

from . import card, check, tracing
from ..reference import pipeline as reference

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'xarray_parcel_tpu')
SAMPLE_COLUMNS = 16384


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Reservoir:
    """One of the calls offered, each as likely as any other, drawn from
    ``rng`` whatever their number."""

    def __init__(self, rng):
        self.rng, self.seen, self.item = rng, 0, None

    def takes_next(self):
        """Whether the next call replaces the one kept."""
        self.seen += 1
        return self.rng.randrange(self.seen) == 0


def sample_columns(seed, columns, n=SAMPLE_COLUMNS):
    """``n`` distinct columns drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    return np.sort(rng.choice(columns, size=min(n, columns), replace=False))


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class Record:
    """What end-to-end metric readers take: the window's per-call seconds
    on the host's clock and on the card's (None without a card), its
    length, the columns a call computes, the window's peak device memory
    and the set-up seconds."""

    def __init__(self, times, card_times, window_s, columns, peak_bytes,
                 setup_s):
        self.times, self.card_times = times, card_times
        self.window_s, self.columns = window_s, columns
        self.peak_bytes, self.setup_s = peak_bytes, setup_s


def window(call, steps, seconds, seed, idx, state, device):
    """Call the program in turn on the time steps for ``seconds``.

    Each call is timed alone on the host's clock and, on a card, between
    two CUDA events recorded before it and after it returns (both run at
    once on the idle card, so they read the call's wall time on the card's
    clock, free of the host clock's half a millisecond).  A reservoir per
    time step keeps one of its calls, so that every step's outputs are
    judged.  Returns (host seconds per call, card seconds per call or None,
    window seconds, kept samples)."""
    keep = [Reservoir(random.Random(f'{int(seed)}:{k}'))
            for k in range(steps)]
    on_card = device.type == 'cuda'
    times, events = [], []
    i = 0
    t0 = time.perf_counter()
    while True:
        k = i % steps
        if on_card:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        a = time.perf_counter()
        out = call(k)
        b = time.perf_counter()
        if on_card:
            pair[1].record()
            events.append(pair)
        times.append(b - a)
        if keep[k].takes_next():
            keep[k].item = (k, state.sample_outputs(out, idx),
                            state.layout_faults(out))
        del out
        i += 1
        if b - t0 >= seconds and i >= steps:
            break
    window_s = time.perf_counter() - t0
    card_times = None
    if on_card:
        torch.cuda.synchronize(device)
        card_times = [s.elapsed_time(e) * 1e-3 for s, e in events]
    return times, card_times, window_s, [r.item for r in keep]


def traced_calls(call, steps, n, state, device):
    """``n`` calls under the profiler; returns (trace, per-call seconds)."""
    profiler = tracing.Profiler()
    times = []
    profiler.start()
    for j in range(n):
        with tracing.call_span():
            a = time.perf_counter()
            call(j % steps)
            times.append(time.perf_counter() - a)
    _sync(device)
    return profiler.stop([state.work[j % steps] for j in range(n)]), times


def judge(state, kept, idx, device, limits):
    """Work the kept columns out again with the reference, after the
    program's inputs are freed, and compare.  Returns (correct, checks,
    numbers)."""
    inputs = [state.sample_inputs(k, idx) for k, _, _ in kept]
    layout = sum(f for _, _, f in kept)
    state.close()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    names = [k for k in reference.OUTPUTS
             if all(k in out for _, out, _ in kept)]
    program = {k: np.concatenate([out[k] for _, out, _ in kept])
               for k in names}
    ins = {k: torch.cat([x[k] for x in inputs]).to(torch.float64)
           for k in inputs[0]}
    want = reference.conv_properties_blocks(
        ins, ignore_nans=bool(state.cfg['ignore_nans']),
        block=len(ins['temperature']))
    want = {k: v.cpu().numpy() for k, v in want.items()}
    numbers = check.compare(program, {k: want[k] for k in names})
    numbers['mu_cape_quantiles'] = np.nanquantile(
        want['mu_cape'], [0.25, 0.5, 0.75, 0.9, 0.99]).round(1).tolist()
    correct, checks = check.verdict(numbers, layout, limits)
    return correct, checks, numbers


def run(cell, seed, seconds, trace, device, started, wrap_call=None):
    """One run.  ``started``: the process's start on ``time.time()``'s
    clock.  ``wrap_call`` (tests only) wraps the timed call.  Returns the
    result (the last line's object) and lines for standard error, the
    compared numbers last."""
    wl = cell.workload
    marks = [('start', time.time() - started)]
    tables = card.tables(device, getattr(torch, cell.config['dtype']))
    marks.append(('tables', time.time() - started))
    state = cell.entry().State(cell, seed, device, tables)
    marks.append(('inputs', time.time() - started))
    call = state.call if wrap_call is None else wrap_call(state.call)
    steps = len(state.steps)
    for k in range(steps):
        call(k % steps)
        _sync(device)
        marks.append((f'warm call {k}', time.time() - started))
    idx = sample_columns(seed, state.columns)
    notes = ['set-up at: ' + ', '.join(f'{k} {v:.3f} s' for k, v in marks)]
    trace = (traced_calls(call, steps, wl['trace_calls'], state, device)
             if trace else None)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    times, card_times, window_s, kept = window(
        call, steps, seconds, seed, idx, state, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    record = Record(times, card_times, window_s, state.columns, peak,
                    setup_s)
    t_judge = time.perf_counter()
    correct, checks, numbers = judge(state, kept, idx, device, wl['limits'])
    notes.append(f'reference and comparison '
                 f'{time.perf_counter() - t_judge:.3f} s on '
                 f'{len(kept) * len(idx)} columns; reference MU CAPE at '
                 f'25, 50, 75, 90, 99%: {numbers["mu_cape_quantiles"]} J/kg')

    metrics = {}
    if trace is None:
        chosen = [(m, record) for m in cell.end_to_end]
    else:
        trace, traced_times = trace
        chosen = [(m, trace) for m in cell.per_layer]
        notes.append(f'traced calls {np.mean(traced_times) * 1e3:.3f} ms '
                     f'against {np.mean(times) * 1e3:.3f} ms untraced '
                     f'(mean); card {card.power_limit()}')
    for m, source in chosen:
        value = cell.reader(m)(source)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'count': 1, 'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct), 'attempted': len(times),
              'failed': 0, 'metrics': metrics, 'device': dev}
    if trace is not None:
        dev['busy_s'] = trace.busy_s()
        dev['window_s'] = trace.window_s
        result['breakdown'] = trace.breakdown()
    result['checks'] = checks
    notes.append(f'calls {len(times)} in {window_s:.3f} s; median '
                 f'{np.median(times) * 1e3:.3f} ms; worst output '
                 f'{numbers["worst_output"]}; kept time steps '
                 f'{[k for k, _, _ in kept]}')
    notes.append('call ms: ' + ' '.join(f'{t * 1e3:.1f}' for t in times))
    notes += [f'{k} {v["value"]!r} limit {v["limit"]!r}'
              for k, v in checks.items()]
    return result, notes
