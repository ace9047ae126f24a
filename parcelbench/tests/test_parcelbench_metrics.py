"""Each metric reader on a small synthetic trace or run record, against
the value worked out by hand."""

import pytest

from parcelbench.harness import cells, runner, tracing
from parcelbench.harness.card import HBM_BYTES_PER_S

BENCH = cells.benchmark()
SOLVE = 'void (anonymous namespace)::fused_cape_cin_kernel<float, false>'
TAIL = 'void (anonymous namespace)::diag_tail_kernel<float>'


def reader(name):
    cell = next(w['name'] for w in BENCH['workloads']
                if cells.reports(next(m for m in BENCH['end_to_end']
                                      + BENCH['per_layer']
                                      if m['name'] == name), w['name']))
    c = cells.Cell(cell)
    return c.reader({'name': name})


def events():
    """Two calls over 0-1000 us: kernels, copies and host spans."""
    ev = [
        dict(ph='X', cat='user_annotation', name=tracing.CALL_SPAN,
             ts=0, dur=400),
        dict(ph='X', cat='user_annotation', name=tracing.CALL_SPAN,
             ts=500, dur=500),
        dict(ph='X', cat='kernel', name=SOLVE, ts=10, dur=100),
        dict(ph='X', cat='kernel', name=SOLVE, ts=120, dur=100),
        dict(ph='X', cat='kernel', name='void other_kernel', ts=200,
             dur=50),
        dict(ph='X', cat='kernel', name=TAIL, ts=600, dur=40),
        dict(ph='X', cat='gpu_memcpy', name='Memcpy HtoD (Pageable -> '
             'Device)', ts=700, dur=100, args={'bytes': 2_000_000}),
        dict(ph='X', cat='gpu_memcpy', name='Memcpy DtoH (Device -> '
             'Pageable)', ts=850, dur=50, args={'bytes': 1000}),
        dict(ph='X', cat='cpu_op', name='aten::copy_', ts=650, dur=60),
        dict(ph='X', cat='cuda_runtime', name='cudaLaunchKernel', ts=300,
             dur=250),
        dict(ph='i', cat='kernel', name='instant', ts=5),
    ]
    return ev


WORK = {'columns': 1000, 'levels': 10, 'valid_levels': 9000, 'itemsize': 4}


def trace():
    return tracing.parse(events(), [WORK, WORK])


def test_parse_window_and_busy():
    t = trace()
    assert t.window == (0.0, 1000.0)
    # busy: 10-110, 120-250, 600-640, 700-800, 850-900
    assert t.busy_s() == pytest.approx(420e-6)
    assert reader('card_idle.device')(t) == pytest.approx(58.0)
    assert reader('card_idle.dataset')(t) == pytest.approx(58.0)


def test_h2d_rate_counts_host_to_device_only():
    assert reader('h2d_gb_per_s.dataset')(trace()) == pytest.approx(20.0)


def test_kernels_per_call():
    assert reader('kernels_per_call.device')(trace()) == pytest.approx(2.0)


def test_rooflines_by_hand():
    t = trace()
    B, L = 1000, 10
    solve_bytes = 4 * (3 * B * L + 3 * B + 7 * B + 14300 * 42)
    solve_ops = (9000 + B) * (3 * 14 + 70)
    least = max(solve_bytes / HBM_BYTES_PER_S, solve_ops / 67e12)
    want = 100 * 2 * 3 * least / 200e-6
    assert reader('solve_roofline.device')(t) == pytest.approx(want)
    tail_bytes = 4 * (4 * B * L + 6 * B)
    least = max(tail_bytes / HBM_BYTES_PER_S, 30 * 9000 / 67e12)
    assert reader('tail_roofline.device')(t) == pytest.approx(
        100 * 2 * least / 40e-6)


def test_readers_without_their_events_return_nothing():
    t = tracing.parse([e for e in events() if e['cat'] == 'user_annotation'],
                      [WORK])
    for name in ('solve_roofline.device', 'tail_roofline.device',
                 'h2d_gb_per_s.dataset', 'kernels_per_call.device',
                 'card_idle.device'):
        assert reader(name)(t) is None


def test_breakdown_ranks_ops_and_labels_gaps():
    b = trace().breakdown()
    assert b['device_ops'][0] == [SOLVE, pytest.approx(200e-6)]
    gaps = dict(b['idle_gaps'])
    # each gap goes to what the host was doing at its middle
    assert gaps['cudaLaunchKernel'] == pytest.approx(350e-6)
    assert gaps['aten::copy_'] == pytest.approx(60e-6)
    assert gaps['host between operations'] == pytest.approx(170e-6)


def test_end_to_end_readers():
    rec = runner.Record(times=[0.2] * 20, card_times=[0.1] * 19 + [0.3],
                        window_s=2.5, columns=1000, peak_bytes=2 ** 31,
                        setup_s=12.5)
    assert reader('device_columns_per_s')(rec) == pytest.approx(8000.0)
    assert reader('host_columns_per_s')(rec) == pytest.approx(8000.0)
    assert reader('device_call_p95_ms')(rec) == pytest.approx(110.0)
    assert reader('peak_device_gib')(rec) == pytest.approx(2.0)
    assert reader('setup_s')(rec) == 12.5
    rec.card_times = None
    assert reader('device_call_p95_ms')(rec) is None
