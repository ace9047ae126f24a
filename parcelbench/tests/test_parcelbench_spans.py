"""The readers of the program's ``xparcel.*`` spans on a small synthetic
trace, against the value worked out by hand: the synthetic trace of
``test_parcelbench_metrics`` with the program's spans and more launches."""

import pytest

from parcelbench.harness import tracing
from parcelbench.tests.test_parcelbench_metrics import WORK, events, reader

READERS = ('lower_ms.dataset', 'lift_ms.dataset',
           'prep_launches_per_call.device', 'prep_idle_ms.device')


def span_trace():
    """In the first call a mix_layer prep (100-300) holding a nested
    neighbors prep (150-200) and overlapped by a conserved prep (280-320),
    in the second a pre-pass (600-700); the lowering 10-60 and 510-580,
    the lift 350-390; launches at 120, 160, 310, 330, 650 and 690 (an
    ``ExC`` launch), and a memcpy call at 620."""
    def host(cat, name, ts, dur):
        return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur)

    extra = [host('user_annotation', f'xparcel.{name}', ts, dur)
             for name, ts, dur in (
                 ('dataset.lower', 10, 50), ('dataset.lower', 510, 70),
                 ('dataset.lift', 350, 40), ('prep.mix_layer', 100, 200),
                 ('prep.neighbors', 150, 50), ('prep.conserved', 280, 40),
                 ('prep.prepass', 600, 100))]
    extra += [host('cuda_runtime', 'cudaLaunchKernel', ts, 5)
              for ts in (120, 160, 310, 330, 650)]
    extra += [host('cuda_runtime', 'cudaLaunchKernelExC', 690, 5),
              host('cuda_runtime', 'cudaMemcpyAsync', 620, 5)]
    return tracing.parse(events() + extra, [WORK, WORK])


def test_dataset_span_readers():
    t = span_trace()
    # (50 + 70) us and 40 us over the 2 calls, in ms
    assert reader('lower_ms.dataset')(t) == pytest.approx(0.06)
    assert reader('lift_ms.dataset')(t) == pytest.approx(0.02)


def test_prep_launches_count_each_launch_once():
    # prep union: 100-320 and 600-700; launches starting inside it: the
    # events() launch at 300, then 120, 160 (under two nested preps: once),
    # 310, 650 and the ExC launch at 690; not 330 nor the memcpy call
    assert reader('prep_launches_per_call.device')(span_trace()) == (
        pytest.approx(3.0))


def test_prep_idle_overlaps_gaps_with_the_prep_union():
    # gaps: 0-10, 110-120, 250-600, 640-700, 800-850, 900-1000; within the
    # union: 110-120 and 250-320 (10 + 70 us), and 640-700 (60 us)
    assert reader('prep_idle_ms.device')(span_trace()) == pytest.approx(
        0.07)


@pytest.mark.parametrize('name', READERS)
def test_span_readers_without_spans_return_nothing(name):
    """A program that records no span (the parent of the spans) gives no
    reading, and raises nothing."""
    assert reader(name)(tracing.parse(events(), [WORK, WORK])) is None


def test_span_split_tool_agrees_with_the_readers():
    """``tools/span_split.py``'s rows for the prep layer and the lowering
    are what the readers read."""
    from parcelbench.tools.span_split import split
    t = span_trace()
    rows = {name: row for name, *row in split(t, 2)}
    assert rows['xparcel.prep.*'] == pytest.approx(
        [2.0, 0.16, reader('prep_launches_per_call.device')(t),
         reader('prep_idle_ms.device')(t)])
    assert rows['xparcel.dataset.lower'][1] == pytest.approx(
        reader('lower_ms.dataset')(t))
    # the nested neighbors prep alone: 150-200, the launch at 160, no idle
    assert rows['xparcel.prep.neighbors'] == pytest.approx(
        [0.5, 0.025, 0.5, 0.0])
