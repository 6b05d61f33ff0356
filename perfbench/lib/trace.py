"""Spans around the harness's calls into the program, and the reduction of a
profiler trace to what the per-layer metrics read.

A ``Tracer`` names each call the harness makes into a layer of the program
(``span``).  With tracing on, the first ``trace_seconds`` of the measured
window run under ``torch.profiler`` with CUDA activity only (recording
every host op as well doubled a call's time on the card, and so the idle
share); spans are host-clock intervals, placed on the trace's clock by its
start time, so the trace's idle gaps can be labelled with the harness span
that was open.  ``summarise`` reduces the events to a
``TraceSummary``: per device, the union of device-op intervals; the device
ops by name; the idle gaps.  Idle is taken over the whole traced window
(its host wall time, opened and closed after a device synchronise), so
host-only stretches at either end count as idle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

@dataclasses.dataclass
class TraceSummary:
    window_s: float  # host wall time of the traced window
    busy_s: list[float]  # per device: union of device-op intervals
    n_device_ops: int  # device kernels, copies and sets the profiler listed
    op_seconds: dict[str, float]  # device time by op name, all devices
    op_launches: dict[str, int]  # device ops by name, all devices
    idle_gaps: list[tuple[str, float]]  # longest gaps, labelled by open span
    span_cover: float = 0.0  # share of device-op time inside a span (clock check)

    @property
    def busy_mean_s(self) -> float:
        return sum(self.busy_s) / max(1, len(self.busy_s))

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_mean_s / self.window_s)

    def kernel_seconds(self, fragment: str) -> tuple[float, int]:
        """(device seconds, launches) of the ops whose name holds ``fragment``."""
        names = [k for k in self.op_seconds if fragment in k]
        return (sum(self.op_seconds[k] for k in names),
                sum(self.op_launches[k] for k in names))

    def top_ops(self, n: int = 10) -> list[list]:
        """The n ops with the most device time, names cut to 160 characters."""
        top = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v] for k, v in top]


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The (start, end) gaps between the merged intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def label_gaps(gap_list, spans, n: int = 10) -> list[tuple[str, float]]:
    """The ``n`` longest gaps (seconds), each labelled by the innermost span
    (name, start, end) open at its midpoint ("no span" outside all)."""
    out = []
    for s, e in sorted(gap_list, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (s + e)
        open_ = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "no span"
        out.append((name, (e - s) * 1e-6))
    return out


class Tracer:
    """Harness spans, and the profiler over the first ``trace_seconds`` of
    the window when ``enabled``."""

    def __init__(self, enabled: bool, trace_seconds: float, devices) -> None:
        self.enabled = enabled
        self.trace_seconds = trace_seconds
        self.devices = list(devices)
        self._prof = None
        self._done = None
        self._spans: list[tuple[str, int, int]] = []
        self._t0 = 0.0
        self.window_s = 0.0
        self.summary: TraceSummary | None = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((name, t, time.time_ns()))

    def _sync(self) -> None:
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self._spans = []
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def maybe_stop(self) -> None:
        """Close the traced window once it has run ``trace_seconds`` (from
        the profiler's start, which itself takes seconds)."""
        if self._prof is not None and time.perf_counter() - self._t0 >= self.trace_seconds:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._done, self._prof = self._prof, None
        self._done.__exit__(None, None, None)

    def summarise(self) -> None:
        """Reduce the closed trace (slow: seconds for every second traced);
        the runners call it after the window."""
        if self._done is not None:
            self.summary = summarise(self._done, self.window_s, len(self.devices), self._spans)
            self._done = None


def trace_start_ns(prof) -> int | None:
    """The trace's start on the host's wall clock (ns), which its event
    times (us) count from; None where this torch does not say."""
    try:
        return int(prof.profiler.kineto_results.trace_start_ns())
    except (AttributeError, RuntimeError):
        return None


def summarise(prof, window_s: float, n_devices: int, host_spans=()) -> TraceSummary:
    """Reduce a closed profile; ``host_spans`` are (name, start, end) on the
    host's wall clock in ns."""
    from torch.autograd import DeviceType

    by_dev: dict[int, list] = {}
    op_s: dict[str, float] = {}
    launches: dict[str, int] = {}
    t0 = trace_start_ns(prof) if host_spans else None
    spans = [] if t0 is None else [(n, (s - t0) * 1e-3, (e - t0) * 1e-3)
                                   for n, s, e in host_spans]
    n_ops = 0
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            by_dev.setdefault(e.device_index, []).append((s, t))
            op_s[e.name] = op_s.get(e.name, 0.0) + (t - s) * 1e-6
            launches[e.name] = launches.get(e.name, 0) + 1
            n_ops += 1
    busy = [union_length(iv) * 1e-6 for iv in by_dev.values()]
    busy += [0.0] * max(0, n_devices - len(busy))
    all_gaps = [g for iv in by_dev.values() for g in gaps(iv)]
    covered = union_length([(max(s, a), min(t, b)) for iv in by_dev.values() for s, t in iv
                            for _, a, b in spans if min(t, b) > max(s, a)])
    return TraceSummary(window_s=window_s, busy_s=busy, n_device_ops=n_ops, op_seconds=op_s,
                        op_launches=launches, idle_gaps=label_gaps(all_gaps, spans),
                        span_cover=covered / max(1e-12, sum(busy) * 1e6))
