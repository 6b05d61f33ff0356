"""tpu3dm_torch's utils: the profiler (utils/profiler.py) with the cases of
tests/test_utils.py, its fence and torch.profiler trace, and the logger's
duplicate-handler guard (utils/logging.py), on the CPU."""

import json
import logging
from dataclasses import dataclass

import numpy as np
import torch

from tpu3dm.utils.logging import setup_logging as j_setup_logging
from tpu3dm_torch.utils.logging import setup_logging
from tpu3dm_torch.utils.profiler import (
    Profiler,
    TimingStats,
    device_memory_stats,
    fence,
    profile,
    profile_block,
    trace,
)


def setup_function(_fn):
    Profiler.reset()
    Profiler.enable()
    Profiler.enable_memory_tracking(False)


def teardown_function(_fn):
    Profiler.enable(False)


def test_span_records_stats():
    for _ in range(3):
        with profile_block("unit/span"):
            pass
    stats = Profiler.get_stats()["unit/span"]
    assert stats.count == 3
    assert stats.total >= 0.0
    assert stats.min <= stats.median <= stats.max


def test_decorator_records_qualname_span():
    @profile(fence_result=True)
    def work(x):
        return x + 1

    assert work(torch.ones(2)).tolist() == [2.0, 2.0]
    (name,) = [k for k in Profiler.get_stats() if "work" in k]
    assert Profiler.get_stats()[name].count == 1


def test_report_and_json(tmp_path):
    with profile_block("unit/a"):
        pass
    assert "unit/a" in Profiler.report()
    p = tmp_path / "spans.json"
    Profiler.save_json(p)
    assert json.loads(p.read_text())["unit/a"]["count"] == 1
    txt = tmp_path / "spans.txt"
    Profiler.save_report(txt)
    assert "unit/a" in txt.read_text()


def test_memory_tracking_opt_in():
    Profiler.enable_memory_tracking(True)
    blobs = []
    with profile_block("unit/alloc"):
        blobs.append(np.ones((4_000_000,), np.float64))
    stats = Profiler.get_stats()["unit/alloc"]
    assert len(stats.rss_deltas) == 1
    assert "avg_rss_delta_mb" in stats.as_dict()
    Profiler.enable_memory_tracking(False)
    with profile_block("unit/noalloc"):
        pass
    assert not Profiler.get_stats()["unit/noalloc"].rss_deltas


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    for _dev, d in stats.items():
        assert all(isinstance(v, int) for v in d.values())


def test_timingstats_empty_safe():
    s = TimingStats("empty")
    assert s.avg == 0.0 and s.median == 0.0 and s.min == 0.0 and s.max == 0.0


def test_fence_walks_containers_and_dataclasses():
    """A fence over CPU tensors, nested containers and dataclasses returns
    its argument and waits for nothing; a span with a fence records."""

    @dataclass
    class Box:
        a: torch.Tensor
        b: list

    box = Box(torch.zeros(2), [torch.ones(1), {"k": (torch.zeros(1),)}, None])
    assert fence(box) is box
    with profile_block("unit/fenced", fence=box):
        pass
    assert Profiler.get_stats()["unit/fenced"].count == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "tr"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert data["traceEvents"]


def test_logger_duplicate_handler_guard():
    """setup_logging twice on one name adds one handler, at INFO, with the
    JAX package's record format."""
    name = "tpu3dm_torch.test.guard"
    logging.getLogger(name).propagate = False  # the root's test-capture handlers count too
    logging.getLogger("tpu3dm.test.guard").propagate = False
    a = setup_logging(name)
    b = setup_logging(name)
    assert a is b and len(a.handlers) == 1 and a.level == logging.INFO
    j = j_setup_logging("tpu3dm.test.guard")
    assert a.handlers[0].formatter._fmt == j.handlers[0].formatter._fmt
