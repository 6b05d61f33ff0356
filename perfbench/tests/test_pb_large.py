"""The full-resolution cell, ``arch1m.large``, on the CPU at a small size
(16,384 points, block 512, a pool of 4 pairs): ``run.main`` drives it end to
end through the overrides; its per-layer readers read the program's
``large.*`` spans and counters; three planted faults each make ``correct``
false (the full-resolution ICP skipped, the pose turned 0.5 deg, a leaf of
the target's partition dropped).  On a card, the control: the reference
with TF32 on fails one of the cell's limits."""

import dataclasses
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import run as bench
from perfbench.lib import costs_large, manifest

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"points": 16384, "block": 512, "check_pairs": 4}
POOL = {"base_pairs": 2, "seed_base_pairs": 1, "motions": 2, "warm_calls": 0}
SEED = "123456789012345"
READERS = ["idle_pct.large", "device_ops_per_pair.large", "nn_blocksparse_roofline",
           "host_ms_per_pair.large_downsample", "host_ms_per_pair.large_features",
           "host_ms_per_pair.large_coarse", "host_ms_per_pair.large_partition",
           "host_ms_per_pair.large_fine", "fine_iters_per_pair.large"]


def _run(capsys, *, trace=0, seed=SEED):
    rc = bench.main(["--workload", "arch1m.large", "--seed", seed, "--seconds", "0.01",
                     "--trace", str(trace)],
                    require_cuda=False, config_overrides=SMALL, traffic_overrides=POOL)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_large_run_is_correct_and_reports_its_metrics(capsys):
    out = _run(capsys)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert set(out["checks"]) == {"gate_miss_share", "pose_gap_deg", "rmse_gap_rel",
                                  "fitness_gap"}


def test_traced_run_reads_the_program_spans(capsys, monkeypatch):
    """Without a card the tracer is off, so the device metrics are absent;
    with the program's recording on, the span and counter readers read the
    window's calls."""
    from tpu3dm_torch.utils.profiler import Profiler

    Profiler.reset()
    monkeypatch.setattr(Profiler, "_enabled", True)
    try:
        out = _run(capsys, trace=1)
    finally:
        Profiler.reset()
    names = {f"host_ms_per_pair.large_{s}" for s in
             ("downsample", "features", "coarse", "partition", "fine")}
    assert names | {"fine_iters_per_pair.large"} == set(out["metrics"])
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("ops, pairs, want", [(None, 8, None), (1000, 0, None),
                                              (146456, 8, 18307.0)])
def test_device_ops_reader_reads_the_traced_calls(ops, pairs, want):
    run = SimpleNamespace(summary=None if ops is None else SimpleNamespace(n_device_ops=ops),
                          work={"pairs_traced": pairs})
    assert manifest.metric_reader(bench.BENCH, "device_ops_per_pair.large").read(run) == want


@pytest.mark.parametrize("seconds, launches, want", [(2e-3, 2, 1e-3 * 2 / 2e-3 * 100),
                                                     (0.0, 0, None), (1e-3, 0, None)])
def test_roofline_reader_takes_launches_times_the_least_time(seconds, launches, want):
    summary = SimpleNamespace(kernel_seconds=lambda frag: (seconds, launches))
    run = SimpleNamespace(summary=summary, work={"nn_blocksparse_launch_s": 1e-3})
    got = manifest.metric_reader(bench.BENCH, "nn_blocksparse_roofline").read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_span_readers_read_nothing_from_a_program_without_them(monkeypatch):
    from perfbench.lib import spans, spans_large

    monkeypatch.setattr(spans, "records", lambda: ([], {"batch.pairs": 4}))
    assert spans_large.host_ms_per_pair("large.fine") is None
    assert spans_large.per_pair("large.fine_iters") is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert spans_large.host_ms_per_pair("large.fine") is None
    for name in READERS[3:]:
        assert manifest.metric_reader(bench.BENCH, name).read(None) is None


def _fine_skipped(real):
    """icp_refine_large cut to its grading: the pose of the downsampled
    polish, with its full-resolution fitness and RMSE."""
    return lambda *a, **k: real(*a, **(k | {"max_iterations": 0}))


def _turned(real):
    """register_arrays_large with its pose turned 0.5 deg about z."""
    def call(*a, **k):
        fine, coarse = real(*a, **k)
        th = math.radians(0.5)
        R = torch.eye(4)
        R[0, 0] = R[1, 1] = math.cos(th)
        R[0, 1], R[1, 0] = -math.sin(th), math.sin(th)
        return dataclasses.replace(fine, transformation=R @ fine.transformation), coarse
    return call


def _leaf_dropped(real):
    """prepare_large_cloud losing the middle leaf of every target it
    partitions (each call's second cloud): its rows become sentinels."""
    from tpu3dm_torch.ops.nn_sparse import SPARSE_PAD

    calls = [0]

    def call(points, **k):
        cloud = real(points, **k)
        calls[0] += 1
        if calls[0] % 2 == 0:
            j = cloud.n // cloud.block // 2
            cloud.points[j * cloud.block:(j + 1) * cloud.block] = SPARSE_PAD
        return cloud
    return call


@pytest.mark.parametrize("fault", ["fine_skipped", "turned", "leaf_dropped"])
def test_large_fault_is_not_correct(capsys, monkeypatch, fault):
    from tpu3dm_torch.registration import large

    name, wrap = {"fine_skipped": ("icp_refine_large", _fine_skipped),
                  "turned": ("register_arrays_large", _turned),
                  "leaf_dropped": ("prepare_large_cloud", _leaf_dropped)}[fault]
    monkeypatch.setattr(large, name, wrap(getattr(large, name)))
    out = _run(capsys)
    assert not out["correct"], out["checks"]
    assert out["failed"] == 0


def test_nn_blocksparse_cost_count_is_perfs_kernel_table():
    # PERF.md's kernel-6 row: 1,000,448^2, 1954 query blocks x w 8, 0.8555 ms.
    t = costs_large.nn_blocksparse_seconds(1954, 8, 512, 1000448)
    assert math.isclose(t, 7.0 * 1000448 * 8 * 512 / 33.5e12)
    assert abs(t * 1e3 - 0.8555) / 0.8555 < 2e-3


def test_manifest_entries_of_the_cell():
    m = manifest.load(ROOT)
    assert manifest.validate(m, ROOT) == []
    cell = manifest.workload(m, "arch1m.large")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("arch1m", "large64", 1)
    assert [x["name"] for x in manifest.metrics_of(m, "arch1m.large", "end_to_end")] == [
        "pairs_per_s", "setup_s"]
    assert [x["name"] for x in manifest.metrics_of(m, "arch1m.large", "per_layer")] == READERS
    assert "arch1m.large" not in {w for x in manifest.metrics_of(m, "scan20k.register",
                                                                  "per_layer")
                                  for w in x["workloads"]}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12])
def test_tf32_control_fails_a_number_of_the_large_cell(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.runners import large

    m = manifest.load(ROOT)
    cell = manifest.workload(m, "arch1m.large")
    cfg = manifest.config(m, ROOT, cell["config"]) | {"check_pairs": 2}
    traffic = manifest.traffic(ROOT / "perfbench", cell["traffic"])
    run = bench.Run(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=0.0,
                    trace=False, devices=[torch.device("cuda", 0)],
                    bench_dir=ROOT / "perfbench")
    _, checks = large.control_numbers(run)
    assert any(not c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]
