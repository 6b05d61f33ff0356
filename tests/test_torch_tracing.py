"""tpu3dm_torch's spans and counters (utils/profiler.py) and where the batch
API and the fused step open them, on the CPU: recording is off by default
and then reads no clock; ``Profiler.enable()`` or an open
``torch.profiler`` session turns it on; records nest by thread and carry
their batched call's id; the ring is bounded; a batched call yields the
span tree and counters the benchmark's readers take, with the same bits as
a call that records nothing; ``idle_by_span`` names each idle instant by
the innermost open span."""

import json
import time

import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.preprocess.pipeline import preprocess_points_batch as j_preprocess_batch
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration import batch as pbatch
from tpu3dm_torch.utils import profiler
from tpu3dm_torch.utils.profiler import (
    NO_SPAN,
    RING_SPANS,
    Profiler,
    Span,
    idle_by_span,
    profile,
    profile_block,
    recording,
    trace,
)

K = 512  # hypotheses a pair
BUCKET = 64  # two buckets for the mixed pairs (704 and 768)


@pytest.fixture(autouse=True)
def _fresh_profiler():
    Profiler.enable(False)
    Profiler.reset()
    yield
    Profiler.enable(False)
    Profiler.reset()


def _boom(*_a, **_k):
    raise AssertionError("an off span read a clock or fenced")


def _span_block():
    with profile_block("off/block"):
        pass


def _fenced_span():
    with Profiler("off/fenced", fence=torch.zeros(2)):
        pass


def _decorated_span():
    profile("off/decorated", fence_result=True)(lambda: torch.ones(1))()


def _counter():
    Profiler.count("off/count", 3)


@pytest.mark.parametrize("use", [_span_block, _fenced_span, _decorated_span, _counter],
                         ids=["profile_block", "fence", "decorator", "count"])
def test_off_by_default_reads_no_clock_and_records_nothing(monkeypatch, use):
    assert not recording()
    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", _boom)
        m.setattr(time, "perf_counter", _boom)
        m.setattr(profiler, "fence", _boom)
        use()
    assert Profiler.spans() == [] and Profiler.counters() == {} and Profiler.get_stats() == {}


def test_enable_records_nested_spans_with_parents_and_call_ids():
    Profiler.enable()
    t_before = time.time_ns()
    with Profiler("outer", call_id=profiler.new_call_id()) as outer:
        with profile_block("mid"):
            with profile_block("leaf"):
                Profiler.count("n", 2)
        with profile_block("mid"):
            Profiler.count("n", 5)
    with profile_block("alone"):
        pass
    t_after = time.time_ns()
    spans = {(s.name, s.index): s for s in Profiler.spans()}
    by_index = {s.index: s for s in spans.values()}
    root = next(s for s in spans.values() if s.name == "outer")
    mids = [s for s in spans.values() if s.name == "mid"]
    leaf = next(s for s in spans.values() if s.name == "leaf")
    alone = next(s for s in spans.values() if s.name == "alone")
    assert root.parent == -1 and root.call_id == outer.call_id
    assert [m.parent for m in mids] == [root.index] * 2
    assert leaf.parent == mids[0].index and by_index[leaf.parent].name == "mid"
    assert {s.call_id for s in (leaf, *mids)} == {outer.call_id}
    assert alone.parent == -1 and alone.call_id == -1
    for s in spans.values():
        assert t_before <= s.start_ns <= s.end_ns <= t_after
    assert root.start_ns <= mids[0].start_ns and mids[1].end_ns <= root.end_ns
    assert Profiler.counters() == {"n": 7}
    assert Profiler.get_stats()["mid"].count == 2


def test_each_batched_call_takes_its_own_call_id_and_resolve_carries_it():
    """Two calls with no pairs: launch, its packing and its resolve carry
    the launch's call id, another for each call."""
    Profiler.enable()
    for _ in range(2):
        pbatch.launch_pairs_batched([], device="cpu").resolve()
    spans = Profiler.spans()
    launches = [s for s in spans if s.name == "batch.launch"]
    resolves = [s for s in spans if s.name == "batch.resolve"]
    packs = [s for s in spans if s.name == "batch.pack"]
    assert len(launches) == len(resolves) == len(packs) == 2
    assert launches[0].call_id != launches[1].call_id
    for launch, resolve, pack in zip(launches, resolves, packs):
        assert resolve.call_id == pack.call_id == launch.call_id
        assert pack.parent == launch.index and resolve.parent == -1
        assert launch.end_ns <= resolve.start_ns


def test_recording_follows_an_open_torch_profiler():
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    assert not recording()
    with torch_profile(activities=[ProfilerActivity.CPU]):
        assert recording()
        with profile_block("profiled"):
            Profiler.count("profiled", 1)
    assert not recording()
    with profile_block("after"):
        Profiler.count("after", 1)
    assert [s.name for s in Profiler.spans()] == ["profiled"]
    assert Profiler.counters() == {"profiled": 1}


def test_the_ring_keeps_at_most_its_bound():
    Profiler.enable()
    for i in range(RING_SPANS + 5):
        with Profiler(f"s{i % 7}"):
            pass
    spans = Profiler.spans()
    assert len(spans) == RING_SPANS
    assert spans[-1].index - spans[0].index == RING_SPANS - 1  # the oldest five left
    assert Profiler.get_stats()["s0"].count == len(range(0, RING_SPANS + 5, 7))


def test_threads_keep_their_own_nesting_and_lose_no_count():
    """More threads than cores, a short switch interval: every count lands,
    and each span's parent is the enclosing span of its own thread."""
    import os
    import sys
    import threading

    n_threads, rounds = 2 * (os.cpu_count() or 2) + 2, 200
    Profiler.enable()

    def work():
        for _ in range(rounds):
            with profile_block("t.outer"):
                with profile_block("t.inner"):
                    Profiler.count("t.n", 1)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert Profiler.counters() == {"t.n": n_threads * rounds}
    spans = Profiler.spans()
    by_index = {s.index: s for s in spans}
    inner = [s for s in spans if s.name == "t.inner"]
    assert len(inner) == n_threads * rounds
    for s in inner:
        up = by_index[s.parent]
        assert up.name == "t.outer" and up.thread == s.thread
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    assert all(s.parent == -1 for s in spans if s.name == "t.outer")


def _port_cloud(jc):
    down = {f: np.asarray(getattr(jc.down, f)) for f in ("points", "normals", "features", "mask")}
    return ProcessedCloud(full=None, down=from_reference_arrays(down, device="cpu"),
                          voxel_size=jc.voxel_size)


@pytest.fixture(scope="module")
def mixed_pairs():
    """Three arch pairs of 3000-6000 points, preprocessed by JAX and carried
    to the port (tests/test_torch_batch.py's ``mixed`` pairs)."""
    raw = []
    for seed, n in ((0, 3000), (1, 6000), (2, 3500)):
        s, t, _ = make_benchmark_pair(n, seed=seed, sigma=0.01)
        raw += [s, t]
    procs = [_port_cloud(c) for c in
             j_preprocess_batch(raw, PipelineConfig.with_voxel_size(0.3).preprocess,
                                full_normals=False)]
    return [(procs[i], procs[i + 1]) for i in range(0, 6, 2)]


def _register(pairs, rescue_restarts):
    torch.set_num_threads(1)
    return pbatch.register_pairs_batched(
        pairs, PConfig.with_voxel_size(0.3), generator=torch.Generator().manual_seed(5),
        ransac_iterations=K, bucket_multiple=BUCKET, rescue_restarts=rescue_restarts,
        device="cpu")


@pytest.mark.parametrize("rescue_restarts", [0, 2])
def test_batched_call_spans_counters_and_bits(mixed_pairs, rescue_restarts):
    prev = torch.get_num_threads()
    try:
        off = _register(mixed_pairs, rescue_restarts)
        assert Profiler.spans() == [] and Profiler.counters() == {}
        Profiler.enable()
        on = _register(mixed_pairs, rescue_restarts)
        Profiler.enable(False)
    finally:
        torch.set_num_threads(prev)

    np.testing.assert_array_equal(on.transforms, off.transforms)
    np.testing.assert_array_equal(on.ransac_fitness, off.ransac_fitness)
    np.testing.assert_array_equal(on.icp_rmse, off.icp_rmse)

    spans = Profiler.spans()
    (launch,) = [s for s in spans if s.name == "batch.launch"]
    (resolve,) = [s for s in spans if s.name == "batch.resolve"]
    n_buckets = len(set(on.bucket_of_pair))
    assert n_buckets == 2
    children: dict[int, list[str]] = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s.name)
        assert s.call_id == launch.call_id
    assert sorted(children[launch.index]) == sorted(["batch.pack"] * (1 + n_buckets)
                                                    + ["fused.step"] * n_buckets)
    stages = ["fused.correspondences", "fused.ransac"] + (
        ["fused.rescue"] if rescue_restarts else []) + ["fused.icp"]
    steps = [s for s in spans if s.name == "fused.step"]
    for step in steps:
        assert children[step.index] == stages  # closed in this order
    assert resolve.parent == -1 and launch.parent == -1
    assert launch.end_ns <= resolve.start_ns
    assert set(children) == {-1, launch.index} | {s.index for s in steps}

    n_valid = [(int(s.down.mask.sum()), int(t.down.mask.sum())) for s, t in mixed_pairs]
    caps = on.bucket_of_pair
    assert Profiler.counters() == {
        "batch.pairs": len(mixed_pairs),
        "batch.rows_valid": sum(min(a, c) + min(b, c) for (a, b), c in zip(n_valid, caps)),
        "batch.rows_padded": sum(2 * c for c in caps),
        "batch.pack_syncs": 1,
        "batch.eager_steps": n_buckets,  # the CPU steps are never graphs
    }


class _Ev:
    def __init__(self, start, end, cuda=True):
        from torch.autograd import DeviceType

        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})()


class _Prof:
    """A closed profile whose trace started at host time T0 ns, with event
    times in us from there."""

    T0 = 5_000_000

    def __init__(self, events):
        self._events = events
        results = type("K", (), {"trace_start_ns": staticmethod(lambda: _Prof.T0)})()
        self.profiler = type("P", (), {"kineto_results": results})()

    def events(self):
        return self._events


def _span(name, start_us, end_us, index=0, thread=1):
    return Span(name, _Prof.T0 + int(start_us * 1e3), _Prof.T0 + int(end_us * 1e3), -1, -1,
                thread, index)


def test_idle_by_span_names_each_idle_instant_by_the_innermost_open_span():
    prof = _Prof([_Ev(100, 300), _Ev(250, 400), _Ev(600, 700), _Ev(420, 430, cuda=False)])
    spans = [
        _span("early", -50, -10),  # ended before the trace: left out
        _span("outer", 50, 900),
        _span("inner", 350, 650),
        _span("leaf", 500, 550),
        _span("other thread", 800, 850, thread=2),
    ]
    idle = idle_by_span(prof, spans)
    # Idle [0, 100], [400, 600], [700, 900] us.
    want = {NO_SPAN: 50, "outer": 50 + 100 + 50, "inner": 150, "leaf": 50, "other thread": 50}
    assert set(idle) == set(want)
    for name, us in want.items():
        assert idle[name] == pytest.approx(us * 1e-6)
    assert sum(idle.values()) == pytest.approx(500e-6)


def test_trace_writes_the_program_spans_and_idle_by_span(tmp_path):
    with trace(tmp_path / "tr"):
        with profile_block("traced"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    mine = [e for e in data["traceEvents"] if e.get("cat") == "program"]
    assert [(e["name"], e["ph"]) for e in mine] == [("traced", "X")]
    assert mine[0]["pid"] not in {e.get("pid") for e in data["traceEvents"]
                                  if e.get("cat") != "program" and e.get("ph") != "M"}
    idle = json.loads((tmp_path / "tr" / "idle_by_span.json").read_text())
    assert idle["traced"] > 0.0
