"""Idle over the traced window, on synthetic event lists."""

import math

import pytest

from perfbench.lib import trace


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8), (10.0, 11.0)]
    assert trace.union_length(iv) == 5.0
    assert trace.gaps(iv) == [(3.0, 5.0), (6.0, 10.0)]
    assert trace.union_length([]) == 0.0
    assert trace.gaps([(1.0, 2.0)]) == []


def test_idle_is_taken_over_the_whole_window():
    # 1 s window (1e6 us of events' clock); device busy 0.25 s on each of two cards.
    s = trace.TraceSummary(window_s=1.0, busy_s=[0.25, 0.25], n_device_ops=4,
                           op_seconds={"k": 0.5}, op_launches={"k": 4}, idle_gaps=[])
    assert math.isclose(s.idle_pct, 75.0)
    assert s.kernel_seconds("k") == (0.5, 4)
    assert s.kernel_seconds("absent") == (0, 0)


def test_gaps_are_labelled_by_the_innermost_open_span():
    gaps = [(10.0, 30.0), (100.0, 400.0), (500.0, 501.0)]
    spans = [("register_pairs_batched", 0.0, 450.0), ("gate", 90.0, 410.0)]
    out = trace.label_gaps(gaps, spans, n=2)
    assert [n for n, _ in out] == ["gate", "register_pairs_batched"]
    assert [s for _, s in out] == pytest.approx([300e-6, 20e-6])
    assert trace.label_gaps([(600.0, 700.0)], spans)[0][0] == "no span"


class _Ev:
    def __init__(self, name, dev, start, end, index=0):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.device_index = index

        class R:
            pass

        self.time_range = R()
        self.time_range.start, self.time_range.end = start, end


class _Prof:
    """A closed profile whose trace started at host time 5,000,000 ns."""

    def __init__(self, events):
        self._e = events

        class K:
            @staticmethod
            def trace_start_ns():
                return 5_000_000

        class P:
            kineto_results = K()

        self.profiler = P()

    def events(self):
        return self._e


def test_summarise_averages_cards_and_places_host_spans_on_the_trace_clock():
    ev = [
        _Ev("(anonymous namespace)::lane_mutual_kernel(...)", True, 100, 300, 0),
        _Ev("elementwise", True, 250, 400, 0),
        _Ev("elementwise", True, 600, 700, 0),
        _Ev("elementwise", True, 600, 700, 1),
        _Ev("aten::add", False, 100, 120),  # host ops are no device ops
    ]
    # A span from 0 to 450 us of the trace's clock, in host ns.
    spans = [("register_pairs_batched", 5_000_000, 5_450_000)]
    s = trace.summarise(_Prof(ev), window_s=0.002, n_devices=2, host_spans=spans)
    assert s.n_device_ops == 4
    assert s.busy_s == pytest.approx([400e-6, 100e-6])
    assert math.isclose(s.idle_pct, 100.0 * (1 - 250e-6 / 0.002))
    assert s.kernel_seconds("lane_mutual_kernel") == (pytest.approx(200e-6), 1)
    assert s.idle_gaps == [("no span", pytest.approx(200e-6))]  # 400 -> 600 us: after the span
    assert s.span_cover == pytest.approx(300 / 500)
