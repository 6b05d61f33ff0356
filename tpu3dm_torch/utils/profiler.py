"""Named-span profiler with device-fenced timing (port of tpu3dm/utils/profiler.py).

A process-global registry of named timing statistics, used as a context
manager (``Profiler``, ``profile_block``) or a decorator (``profile``), with
a sortable text report and file export.  A span given a ``fence`` (tensors,
or containers and dataclasses of them) synchronizes their CUDA devices
before it stops the clock, so device work is measured rather than its
launch.  ``trace(dir)`` records a ``torch.profiler`` Chrome trace.
Per-span host-RSS deltas are opt-in (``Profiler.enable_memory_tracking``,
read from /proc/self/statm); ``device_memory_stats()`` reads the CUDA
caching allocator's byte counters.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import wraps
from pathlib import Path
from typing import Any, Callable

import torch


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


class Profiler:
    """Process-global named-span timing registry."""

    _stats: dict[str, TimingStats] = {}
    _track_memory: bool = False

    def __init__(self, name: str, fence: Any = None):
        self.name = name
        self._fence = fence
        self._t0 = 0.0
        self._rss0 = 0

    def __enter__(self) -> Profiler:
        if Profiler._track_memory:
            self._rss0 = _rss_bytes()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._fence is not None:
            fence(self._fence)
        elapsed = time.perf_counter() - self._t0
        rss_delta = _rss_bytes() - self._rss0 if Profiler._track_memory else None
        self.record(self.name, elapsed, rss_delta)

    @classmethod
    def enable_memory_tracking(cls, enabled: bool = True) -> None:
        """Opt-in per-span host-RSS deltas."""
        cls._track_memory = enabled

    @classmethod
    def record(cls, name: str, elapsed: float, rss_delta: int | None = None) -> None:
        cls._stats.setdefault(name, TimingStats(name)).add(elapsed, rss_delta)

    @classmethod
    def get_stats(cls) -> dict[str, TimingStats]:
        return dict(cls._stats)

    @classmethod
    def reset(cls) -> None:
        cls._stats.clear()

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
    return value before the span closes."""

    def deco(fn: Callable) -> Callable:
        span = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            with Profiler(span):
                out = fn(*args, **kwargs)
                if fence_result:
                    fence(out)
            return out

        return wrapper

    return deco


@contextmanager
def trace(log_dir: str | Path):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where
    available), written as ``trace.json`` (Chrome trace format) under
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
