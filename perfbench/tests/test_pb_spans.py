"""The readers of the program's spans and counters (``lib/spans.py`` and the
seven ``metrics/`` files that use it): hand-computed values from records
the program made, self time net of children; None with nothing recorded or
with no span API; the manifest's entries.  On a card (``gpu``): the
program's spans and the device trace share one clock."""

import time
from pathlib import Path

import pytest

from perfbench.lib import manifest, spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
PAIRS = 4

# Self time (ns) a name has in the records ``_record`` makes.
SELF_NS = {
    "batch.pack": 3_000 + (4_000 - 2_500),  # the second pack: 4,000 less a child's 2,500
    "fused.correspondences": 2_000,
    "fused.ransac": 6_000,
    "fused.rescue": 1_000,
    "fused.icp": 1_500 - 500,  # two overlapping children cover 500 of it
    "batch.resolve": 7_000,
}
METRICS = {
    "host_us_per_pair.pack": "batch.pack",
    "host_us_per_pair.correspondences": "fused.correspondences",
    "host_us_per_pair.ransac": "fused.ransac",
    "host_us_per_pair.rescue": "fused.rescue",
    "host_us_per_pair.icp": "fused.icp",
    "host_us_per_pair.resolve": "batch.resolve",
}
ROWS_VALID, ROWS_PADDED = 300, 400


@pytest.fixture
def program():
    from tpu3dm_torch.utils.profiler import Profiler

    Profiler.enable(False)
    Profiler.reset()
    yield Profiler
    Profiler.enable(False)
    Profiler.reset()


def _record(Profiler, monkeypatch):
    """One batched call's spans on a clock the test sets (ns), with the
    counters of 4 pairs."""
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
    call = new_call_id()
    span("batch.launch", 0, 30_000, call_id=call, kids=[
        ("batch.pack", 1_000, 4_000),
        ("batch.pack", 5_000, 9_000, [("pack.child", 6_000, 8_500)]),
        ("fused.step", 10_000, 22_000, [
            ("fused.correspondences", 10_500, 12_500),
            ("fused.ransac", 12_500, 18_500),
            ("fused.rescue", 18_500, 19_500),
            ("fused.icp", 19_500, 21_000, [("icp.a", 19_600, 19_900),
                                           ("icp.b", 19_800, 20_100)]),
        ]),
    ])
    span("batch.resolve", 31_000, 38_000, call_id=call)
    Profiler.count("batch.pairs", PAIRS)
    Profiler.count("batch.rows_valid", ROWS_VALID)
    Profiler.count("batch.rows_padded", ROWS_PADDED)
    Profiler.enable(False)


def _read(name):
    return manifest.metric_reader(BENCH, name).read(None)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_host_time_readers_give_self_time_a_pair(program, monkeypatch, name):
    _record(program, monkeypatch)
    assert _read(name) == pytest.approx(SELF_NS[METRICS[name]] * 1e-3 / PAIRS)


def test_pad_reader_gives_the_padded_share(program, monkeypatch):
    _record(program, monkeypatch)
    assert _read("pad_pct.batch") == pytest.approx(100.0 * (1 - ROWS_VALID / ROWS_PADDED))


def test_self_time_is_net_of_direct_children_only(program, monkeypatch):
    _record(program, monkeypatch)
    got = spans.self_ns(program.spans())
    assert {k: got[k] for k in SELF_NS} == SELF_NS
    assert got["batch.launch"] == 30_000 - 3_000 - 4_000 - 12_000
    assert got["fused.step"] == 12_000 - 10_500


@pytest.mark.parametrize("name", sorted(METRICS) + ["pad_pct.batch"])
@pytest.mark.parametrize("state", ["nothing recorded", "no span API"])
def test_readers_give_none_with_nothing_to_read(program, monkeypatch, name, state):
    if state == "no span API":
        _record(program, monkeypatch)
        monkeypatch.delattr(program, "spans")
        monkeypatch.delattr(program, "counters")
    assert _read(name) is None


def test_manifest_has_the_seven_entries_and_accepts_them():
    m = manifest.load(ROOT)
    assert manifest.validate(m, ROOT) == []
    entries = {x["name"]: x for x in m["per_layer"]}
    for name in [*METRICS, "pad_pct.batch"]:
        e = entries[name]
        assert e["workloads"] == ["scan20k.register"] and e["moves"] == "pairs_per_s"
        assert e["layer"] == "registration" and e["better"] == "lower"
        assert e["source"] == ("program_counter" if name == "pad_pct.batch" else "program_span")
        assert (BENCH / "metrics" / f"{name}.py").is_file()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_program_spans_and_the_device_trace_share_a_clock(card, program):
    """One traced 512-pair call of scan20k.register: every mutual-search
    kernel starts after the call's first correspondence span opens, and
    99% of the call's device time lies between its launch's start and its
    resolve's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench import run as bench
    from perfbench.lib.trace import trace_start_ns

    m = manifest.load(ROOT)
    cell = manifest.workload(m, "scan20k.register")
    run = bench.Run(cell=cell, config=manifest.config(m, ROOT, cell["config"]),
                    traffic=manifest.traffic(BENCH, cell["traffic"]), seed=2_718_281_828,
                    seconds=0.0, trace=False, devices=[card], bench_dir=BENCH)
    drv = manifest.runner(BENCH, run.traffic["runner"]).Runner(run)
    drv.setup()
    program.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drv._call(0)
        torch.cuda.synchronize(card)
    t0 = trace_start_ns(prof)
    recs = program.spans()
    (launch,) = [s for s in recs if s.name == "batch.launch"]
    (resolve,) = [s for s in recs if s.name == "batch.resolve"]
    assert resolve.call_id == launch.call_id
    first_corr = min(s.start_ns for s in recs if s.name == "fused.correspondences")
    ops = [(t0 + e.time_range.start * 1e3, t0 + e.time_range.end * 1e3, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    mutual = [s for s, _, name in ops if "lane_mutual_kernel" in name]
    assert mutual and min(mutual) >= first_corr
    total = sum(e - s for s, e, _ in ops)
    inside = sum(max(0.0, min(e, resolve.end_ns) - max(s, launch.start_ns)) for s, e, _ in ops)
    print(f"clock check: {len(ops)} device ops, {inside / total:.6f} of their time inside "
          f"the call; first mutual search {(min(mutual) - first_corr) * 1e-3:.1f} us after "
          "the first correspondence span opened")
    assert inside >= 0.99 * total
