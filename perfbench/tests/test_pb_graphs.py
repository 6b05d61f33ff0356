"""The readers of the batch API's graph records (``metrics/
graph_replay_pct.batch.py``, ``metrics/host_us_per_pair.graph.py``): the
replayed share of the bucket steps from the program's three step counters,
the ``batch.graph`` self time a pair from its spans; None with nothing
recorded, with no span API, or from a program that counts no steps by kind;
the manifest's entries."""

import time
from pathlib import Path

import pytest

from perfbench.lib import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
PAIRS = 8
STEPS = {"batch.graph_replays": 6, "batch.graph_captures": 1, "batch.eager_steps": 1}
NAMES = ("graph_replay_pct.batch", "host_us_per_pair.graph")


@pytest.fixture
def program():
    from tpu3dm_torch.utils.profiler import Profiler

    Profiler.enable(False)
    Profiler.reset()
    yield Profiler
    Profiler.enable(False)
    Profiler.reset()


def _record(Profiler, monkeypatch, steps=STEPS):
    """Two replays' spans under one launch on a clock the test sets (ns), one
    of them with a child, and the counters."""
    from tpu3dm_torch.utils.profiler import new_call_id

    now = [0]
    monkeypatch.setattr(time, "time_ns", lambda: now[0])

    def span(name, start, end, kids=(), **kw):
        now[0] = start
        with Profiler(name, **kw):
            for kid in kids:
                span(*kid)
            now[0] = end

    Profiler.enable()
    span("batch.launch", 0, 50_000, call_id=new_call_id(), kids=[
        ("batch.pack", 1_000, 4_000),
        ("batch.graph", 5_000, 9_000),
        ("batch.graph", 10_000, 16_000, [("graph.child", 11_000, 12_500)]),
    ])
    Profiler.count("batch.pairs", PAIRS)
    for name, n in steps.items():
        Profiler.count(name, n)
    Profiler.enable(False)


def _read(name):
    return manifest.metric_reader(BENCH, name).read(None)


def test_replay_share_from_the_step_counters(program, monkeypatch):
    _record(program, monkeypatch)
    assert _read("graph_replay_pct.batch") == pytest.approx(100.0 * 6 / 8)


def test_graph_host_time_a_pair_is_its_self_time(program, monkeypatch):
    _record(program, monkeypatch)
    self_ns = 4_000 + (6_000 - 1_500)
    assert _read("host_us_per_pair.graph") == pytest.approx(self_ns * 1e-3 / PAIRS)


def test_all_eager_steps_read_no_replays_and_no_graph_time(program, monkeypatch):
    from tpu3dm_torch.utils.profiler import Profiler

    Profiler.enable()
    with Profiler("batch.launch"):
        pass
    Profiler.count("batch.pairs", PAIRS)
    Profiler.count("batch.eager_steps", 2)
    Profiler.enable(False)
    assert _read("graph_replay_pct.batch") == 0.0
    assert _read("host_us_per_pair.graph") == 0.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("state", ["nothing recorded", "no span API", "no step counters"])
def test_readers_give_none_with_nothing_to_read(program, monkeypatch, name, state):
    if state == "no span API":
        _record(program, monkeypatch)
        monkeypatch.delattr(program, "spans")
        monkeypatch.delattr(program, "counters")
    elif state == "no step counters":  # a program without the graphs
        _record(program, monkeypatch, steps={})
    assert _read(name) is None


def test_manifest_entries():
    m = manifest.load(ROOT)
    assert manifest.validate(m, ROOT) == []
    entries = {x["name"]: x for x in m["per_layer"]}
    for name, unit, better, source in (("graph_replay_pct.batch", "%", "higher",
                                        "program_counter"),
                                       ("host_us_per_pair.graph", "us/pair", "lower",
                                        "program_span")):
        assert entries[name] == {"name": name, "unit": unit, "better": better, "source": source,
                                 "layer": "registration", "moves": "pairs_per_s",
                                 "workloads": ["scan20k.register"]}
        assert (BENCH / "metrics" / f"{name}.py").is_file()
