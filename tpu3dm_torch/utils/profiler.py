"""Named-span profiler with device-fenced timing (port of tpu3dm/utils/profiler.py).

Spans are context managers (``Profiler``, ``profile_block``) or a decorator
(``profile``); counters are named host integers (``Profiler.count``).
Recording is off by default.  It is on while ``Profiler.enable()`` is in
effect or a ``torch.profiler`` session is open in the process, so a
profiled run records the program's spans with no switch of its own.  A span
that is off tests that flag and nothing else: it reads no clock, records
nothing and fences nothing.

A span that is on appends one ``Span`` record to a bounded ring
(``RING_SPANS`` records): its name; its start and end on
``time.time_ns()``, the host's wall clock, from which
``torch.profiler``'s ``kineto_results.trace_start_ns()`` counts the device
trace's event times, so a record lays over the trace with no further
conversion; its parent (the innermost span open on the same thread when it
opened, or -1); the batched call it belongs to (``new_call_id``, inherited
from the parent); and its thread.  It also adds its duration to the name's
``TimingStats`` for the text report.  Spans and counters never synchronise,
launch device work or read a tensor's value.  A span given a ``fence``
(tensors, or containers and dataclasses of them) synchronizes their CUDA
devices before it stops the clock, only while recording.

``idle_by_span`` attributes a closed profile's device idle time to the
program's spans; ``trace(dir)`` records a ``torch.profiler`` Chrome trace
with the program's spans on a track of their own, and that attribution
beside it.  Per-span host-RSS deltas are opt-in
(``Profiler.enable_memory_tracking``, read from /proc/self/statm);
``device_memory_stats()`` reads the CUDA caching allocator's byte counters.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import wraps
from pathlib import Path
from typing import Any, Callable, NamedTuple

import torch
import torch.autograd.profiler as _torch_autograd_profiler

RING_SPANS = 65_536  # records the ring keeps; older ones drop out
NO_SPAN = "no span"  # idle_by_span's label outside every span


def _rss_bytes() -> int:
    """Current resident-set size in bytes (Linux; 0 where unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096
    except (OSError, ValueError, IndexError):
        return 0


def _cuda_devices(x: Any, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def fence(x: Any) -> Any:
    """Wait for the CUDA devices of every tensor in ``x`` (tensors, lists,
    tuples, dicts and dataclasses of them); returns ``x``."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


def device_memory_stats() -> dict[str, dict[str, int]]:
    """Per-device byte counters of the CUDA caching allocator
    (``torch.cuda.memory_stats``); empty without CUDA."""
    out: dict[str, dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                                if isinstance(v, (int, float)) and "bytes" in k}
    return out


@dataclass
class TimingStats:
    """Aggregate statistics of one named span."""

    name: str
    times: list[float] = field(default_factory=list)
    rss_deltas: list[int] = field(default_factory=list)

    def add(self, elapsed: float, rss_delta: int | None = None) -> None:
        self.times.append(elapsed)
        if rss_delta is not None:
            self.rss_deltas.append(rss_delta)

    @property
    def count(self) -> int:
        return len(self.times)

    @property
    def total(self) -> float:
        return sum(self.times)

    @property
    def avg(self) -> float:
        return self.total / self.count if self.times else 0.0

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0

    @property
    def min(self) -> float:
        return min(self.times) if self.times else 0.0

    @property
    def max(self) -> float:
        return max(self.times) if self.times else 0.0

    def as_dict(self) -> dict[str, float]:
        d = {
            "count": self.count,
            "total_ms": self.total * 1e3,
            "avg_ms": self.avg * 1e3,
            "median_ms": self.median * 1e3,
            "min_ms": self.min * 1e3,
            "max_ms": self.max * 1e3,
        }
        if self.rss_deltas:
            d["avg_rss_delta_mb"] = sum(self.rss_deltas) / len(self.rss_deltas) / 1e6
            d["max_rss_delta_mb"] = max(self.rss_deltas) / 1e6
        return d


class Span(NamedTuple):
    """One recorded span."""

    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: int  # index of the enclosing span on the same thread, -1 at the top
    call_id: int  # the batched call the span belongs to, -1 outside one
    thread: int  # threading.get_ident()
    index: int  # the span's own number, in the order spans opened


_CALL_IDS = itertools.count()
_SPAN_IDS = itertools.count()
_OPEN = threading.local()  # .stack: the Profiler spans open on this thread


def new_call_id() -> int:
    """A new process-wide id for one batched call."""
    return next(_CALL_IDS)


def recording() -> bool:
    """Whether spans and counters record: ``Profiler.enable()`` is in effect
    or a ``torch.profiler`` session is open in the process."""
    return Profiler._enabled or _torch_autograd_profiler._is_profiler_enabled


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class Profiler:
    """A named span, and the process-global registry of recorded spans,
    counters and per-name timing statistics.

    ``call_id`` names the batched call the span belongs to; None inherits
    the enclosing span's (-1 without one)."""

    _stats: dict[str, TimingStats] = {}
    _track_memory: bool = False
    _enabled: bool = False
    _spans: deque[Span] = deque(maxlen=RING_SPANS)
    _counters: dict[str, int] = {}
    _counters_lock = threading.Lock()

    def __init__(self, name: str, fence: Any = None, *, call_id: int | None = None):
        self.name = name
        self.call_id = call_id
        self.on = False  # whether this use of the span records
        self._fence = fence

    def __enter__(self) -> Profiler:
        self.on = recording()
        if not self.on:
            return self
        stack = _open_spans()
        up = stack[-1] if stack else None
        self._index = next(_SPAN_IDS)
        self._parent = up._index if up is not None else -1
        self._call = (self.call_id if self.call_id is not None
                      else up._call if up is not None else -1)
        stack.append(self)
        self._rss0 = _rss_bytes() if Profiler._track_memory else None
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if not self.on:
            return
        if self._fence is not None:
            fence(self._fence)
        t1 = time.time_ns()
        rss_delta = None if self._rss0 is None else _rss_bytes() - self._rss0
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        Profiler._spans.append(Span(self.name, self._t0, t1, self._parent, self._call,
                                    threading.get_ident(), self._index))
        self.record(self.name, (t1 - self._t0) * 1e-9, rss_delta)

    @classmethod
    def enable(cls, enabled: bool = True) -> None:
        """Record spans and counters from now on; False records them only
        while a ``torch.profiler`` session is open."""
        cls._enabled = enabled

    @classmethod
    def enable_memory_tracking(cls, enabled: bool = True) -> None:
        """Opt-in per-span host-RSS deltas."""
        cls._track_memory = enabled

    @classmethod
    def count(cls, name: str, n: int) -> None:
        """Add the host integer ``n`` to counter ``name``, while recording."""
        if recording():
            with cls._counters_lock:
                cls._counters[name] = cls._counters.get(name, 0) + n

    @classmethod
    def spans(cls) -> list[Span]:
        """The recorded spans the ring holds, in the order they closed."""
        return list(cls._spans)

    @classmethod
    def counters(cls) -> dict[str, int]:
        with cls._counters_lock:
            return dict(cls._counters)

    @classmethod
    def record(cls, name: str, elapsed: float, rss_delta: int | None = None) -> None:
        cls._stats.setdefault(name, TimingStats(name)).add(elapsed, rss_delta)

    @classmethod
    def get_stats(cls) -> dict[str, TimingStats]:
        return dict(cls._stats)

    @classmethod
    def reset(cls) -> None:
        """Clear the timing statistics, the recorded spans and the counters."""
        cls._stats.clear()
        cls._spans.clear()
        with cls._counters_lock:
            cls._counters.clear()

    @classmethod
    def report(cls, sort_by: str = "total") -> str:
        rows = sorted(cls._stats.values(), key=lambda s: getattr(s, sort_by), reverse=True)
        lines = [
            f"{'name':<48} {'count':>7} {'total ms':>10} {'avg ms':>9} "
            f"{'median':>9} {'min':>9} {'max':>9}",
            "-" * 106,
        ]
        for s in rows:
            line = (f"{s.name:<48} {s.count:>7} {s.total * 1e3:>10.2f} "
                    f"{s.avg * 1e3:>9.3f} {s.median * 1e3:>9.3f} "
                    f"{s.min * 1e3:>9.3f} {s.max * 1e3:>9.3f}")
            if s.rss_deltas:
                line += f"  rss {sum(s.rss_deltas) / len(s.rss_deltas) / 1e6:+.1f} MB"
            lines.append(line)
        return "\n".join(lines)

    @classmethod
    def print_report(cls, sort_by: str = "total") -> None:
        print(cls.report(sort_by))

    @classmethod
    def save_report(cls, path: str | Path, sort_by: str = "total") -> None:
        Path(path).write_text(cls.report(sort_by) + "\n")

    @classmethod
    def save_json(cls, path: str | Path) -> None:
        Path(path).write_text(json.dumps({k: v.as_dict() for k, v in cls._stats.items()},
                                         indent=2))


@contextmanager
def profile_block(name: str, fence: Any = None):
    """Context-manager span."""
    with Profiler(name, fence=fence):
        yield


def profile(name: str | None = None, fence_result: bool = False) -> Callable:
    """Decorator span; ``fence_result`` waits for the CUDA devices of the
    return value before the span closes, while recording."""

    def deco(fn: Callable) -> Callable:
        span = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            with Profiler(span) as p:
                out = fn(*args, **kwargs)
                if fence_result and p.on:
                    fence(out)
            return out

        return wrapper

    return deco


def _idle(busy: list[tuple[float, float]], hi: float) -> list[tuple[float, float]]:
    """The stretches of [0, hi] that no (start, end) interval covers."""
    out, cur = [], 0.0
    for s, e in sorted(busy):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def _innermost(spans: list[tuple[str, float, float]], hi: float) -> list[tuple[float, float, str]]:
    """[0, hi] cut into (start, end, name) pieces, each named by the innermost
    span (name, start, end) open over it: the latest to open, then the
    earliest to close; ``NO_SPAN`` where none is."""
    cuts = sorted({0.0, hi} | {t for _, s, e in spans for t in (s, e) if 0.0 < t < hi})
    by_start = sorted(spans, key=lambda sp: sp[1])
    active: list = []
    k = 0
    out = []
    for a, b in zip(cuts, cuts[1:]):
        while k < len(by_start) and by_start[k][1] <= a:
            active.append(by_start[k])
            k += 1
        active = [sp for sp in active if sp[2] > a]
        name = max(active, key=lambda sp: (sp[1], -sp[2]))[0] if active else NO_SPAN
        out.append((a, b, name))
    return out


def idle_by_span(prof, spans: list[Span]) -> dict[str, float]:
    """The devices' idle seconds in a closed ``torch.profiler`` profile,
    by the innermost of ``spans`` open at each idle instant (``NO_SPAN``
    outside them all).

    Idle is every instant at which no CUDA op of the profile runs on any
    device, from the trace's start (``trace_start_ns``, on the clock of the
    spans) to the last end of its device ops and of the spans."""
    from torch.autograd import DeviceType

    t0 = int(prof.profiler.kineto_results.trace_start_ns())
    busy = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    marks = [(sp.name, (sp.start_ns - t0) * 1e-3, (sp.end_ns - t0) * 1e-3) for sp in spans
             if sp.end_ns > t0]
    hi = max([e for _, e in busy] + [e for _, _, e in marks], default=0.0)
    pieces = _innermost(marks, hi)
    out: dict[str, float] = {}
    j = 0
    for s, e in _idle(busy, hi):
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            out[name] = out.get(name, 0.0) + (min(b, e) - max(a, s)) * 1e-6
            k += 1
    return out


def _add_span_track(path: Path, spans: list[Span]) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    on a process track of their own, on the trace's time base."""
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = "program spans"
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for sp in spans:
        events.append({"ph": "X", "cat": "program", "name": sp.name, "pid": pid,
                       "tid": sp.thread, "ts": (sp.start_ns - base) * 1e-3,
                       "dur": (sp.end_ns - sp.start_ns) * 1e-3,
                       "args": {"index": sp.index, "parent": sp.parent,
                                "call_id": sp.call_id}})
    path.write_text(json.dumps(data))


@contextmanager
def trace(log_dir: str | Path):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where
    available), written under ``log_dir``: ``trace.json`` (Chrome trace
    format) with the program's spans of the block as complete events on a
    track of their own, and ``idle_by_span.json``, the devices' idle seconds
    by program span (``idle_by_span``)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    t0 = int(prof.profiler.kineto_results.trace_start_ns())
    spans = [sp for sp in Profiler.spans() if sp.end_ns > t0]
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    _add_span_track(path, spans)
    (log_dir / "idle_by_span.json").write_text(
        json.dumps(idle_by_span(prof, spans), indent=2, sort_keys=True) + "\n")
