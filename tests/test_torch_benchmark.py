"""tpu3dm_torch.apps.kernelbench and apps/benchmark.py on the CPU.

The kernel benchmark's cost model (each input read once, each output written
once; the function's fp32 instructions) and its runner on small shapes
patched in.  Each of the ten benchmark runners at a tiny size: its report
carries the keys of JAX's report (the committed ``benchmark_*.json`` files
at the repository root, written by ``tpu3dm/apps/benchmark.py``), less the
keys the port drops (``benchmark.DROPPED_KEYS``) and with the scaling
model's part-named keys renamed (``RENAMED``), and its quality fields are
inside the gate.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm_torch.apps import benchmark as bm
from tpu3dm_torch.apps import kernelbench as kb
from tpu3dm_torch.io.ply import write_ply

ROOT = Path(__file__).resolve().parents[1]
# JAX's scaling-model keys that name the hardware they were measured on
# (tpu3dm/apps/benchmark.py:1274-1276), and the port's names for them.
RENAMED = {
    "nn_rate_entries_per_s_measured_v5e": "nn_rate_entries_per_s_measured",
    "ici_bytes_per_s_per_link": "link_bytes_per_s_per_direction",
    "compiled_collective_census": "collective_census",
}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Kernel benchmark
# ---------------------------------------------------------------------------


def test_hardware_model_is_the_h100():
    cuda = kb.PEAKS["cuda"]
    assert "H100" in cuda["name"]
    assert cuda["hbm_bytes_per_s"] == 3.35e12
    assert cuda["fp32_ops_per_s"] == cuda["fp32_flops"] / 2 == 33.5e12
    assert cuda["bf16_tensor_flops"] == 989e12


@pytest.mark.parametrize("nq, nt, d, ops_per_entry", [(1000, 2000, 3, 9.0), (512, 300, 33, 34.0)])
def test_nn_case_cost_model(nq, nt, d, ops_per_entry):
    for dense in (False, True):
        c = kb._nn_case(nq, nt, d, dense=dense)
        assert c.name == f"nn_{'dense' if dense else 'tiled'}_{nq}x{nt}_d{d}"
        assert c.entries == nq * nt
        assert c.hbm_bytes == 4 * d * (nq + nt) + 8 * nq
        assert c.fp32_ops == ops_per_entry * nq * nt and c.tensor_flops == 0


def test_score_case_cost_model_and_roofline():
    c = kb._score_case(4096, 65536, dense=False)
    assert c.name == "score_lane_4096x65536"
    assert c.hbm_bytes == 4096 * 72 + 65536 * 69
    assert c.fp32_ops == 19 * 4096 * 65536
    peaks = kb.PEAKS["cuda"]
    c.time_s = 2 * c.fp32_ops / peaks["fp32_ops_per_s"]
    row = c.roofline(peaks)
    assert row["sol_bound"] == "fp32" and row["pct_of_sol"] == 50.0
    assert row["sol_time_ms"] == round(c.fp32_ops / peaks["fp32_ops_per_s"] * 1e3, 4)
    assert kb.sol_time(peaks, 3.35e12) == (1.0, "hbm")
    assert kb.sol_time(peaks, 0.0, fp32=1.0, tensor=989e12) == (1.0, "tensor")


def test_kernel_benchmark_runs_on_small_shapes(monkeypatch, tmp_path):
    monkeypatch.setattr(kb, "NN_SHAPES_QUICK", [(512, 256, 3), (256, 512, 33)])
    monkeypatch.setattr(kb, "NN_SHAPES_FULL", [(1024, 512, 3)])
    monkeypatch.setattr(kb, "DENSE_SHAPE", (128, 128, 33))
    monkeypatch.setattr(kb, "SCORE_SHAPES_QUICK", [(128, 256)])
    monkeypatch.setattr(kb, "SCORE_SHAPES_FULL", [(64, (1 << 18) + 256)])
    out = tmp_path / "roof.json"
    report = kb.run_kernel_benchmark(device="cpu", out_path=str(out), reps=1)
    assert json.loads(out.read_text()) == report
    names = [r["name"] for r in report["cases"]]
    assert names == ["nn_tiled_512x256_d3", "nn_tiled_256x512_d33", "nn_tiled_1024x512_d3",
                     "nn_dense_128x128_d33", "score_dense_128x256", "score_lane_64x262400"]
    assert report["hardware_model"] == kb.PEAKS["cpu"] and report["backend"] == "cpu"
    for r in report["cases"]:
        assert r["time_ms"] > 0 and r["sol_bound"] in ("hbm", "fp32", "tensor")
        assert r["pct_of_sol"] is not None and r["pct_of_sol"] >= 0
    quick = kb.run_kernel_benchmark(quick=True, device="cpu", out_path=None, reps=1)
    assert len(quick["cases"]) == 4


def test_kernel_inputs_route_through_the_kernels_plain_versions():
    """The score cases' one-lane operands give score_hypotheses' counts."""
    from tpu3dm_torch.ops.ransac_score import score_features, score_hypotheses_dense

    rng = np.random.default_rng(0)
    R, t, p, q, m = kb.score_inputs(64, 512, rng, torch.device("cpu"))
    counts = score_features(*kb.score_lane_operands(R, t, p, q, m), kb.SCORE_THRESH_SQ)[0]
    assert torch.equal(counts, score_hypotheses_dense(R, t, p, q, m, kb.SCORE_THRESH_SQ))


# ---------------------------------------------------------------------------
# Benchmark runners at tiny sizes
# ---------------------------------------------------------------------------


def _jax_keys(name: str) -> dict:
    return json.loads((ROOT / name).read_text())


def _expected(jax_keys, dropped=()):
    return {RENAMED.get(k, k) for k in jax_keys} - set(dropped)


def _dropped(runner):
    return {key for r, key, _ in bm.DROPPED_KEYS if r == runner}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    s, t, _ = make_benchmark_pair(4000, seed=1, sigma=0.005)
    write_ply(d / "s.ply", s)
    write_ply(d / "t.ply", t)
    return d


def test_dropped_keys_are_listed():
    assert {k for _, k, _ in bm.DROPPED_KEYS} == {"latency_p50_pcie_projected_ms",
                                                  "pcie_projected_pairs_per_sec"}


def test_comprehensive_benchmark(files):
    r = bm.run_comprehensive_benchmark(
        str(files / "s.ply"), str(files / "t.ply"), test_iterations=2, ransac_iterations=256,
        out_txt=str(files / "c.txt"), out_json=str(files / "c.json"), device="cpu")
    j = _jax_keys("benchmark_results.json")
    assert set(r) == set(j)
    for k in ("config", "quality", "derived"):
        assert set(r[k]) == set(j[k]), k
    assert set(r["spans"]) == set(j["spans"])
    assert "preprocessing_warm" in (files / "c.txt").read_text()
    assert r["quality"]["ransac_fitness"] > 0.2


def test_fpfh_ab_benchmark(files):
    r = bm.run_fpfh_ab_benchmark(n_points=4000, seeds=(0,), out_json=str(files / "f.json"),
                                 device="cpu")
    j = _jax_keys("benchmark_fpfh_ab.json")
    assert set(r) == set(j) and r["configs"] == j["configs"]
    for label in ("capped", "uncapped"):
        assert set(r["results"][label][0]) == set(j["results"][label][0])
        assert r["results"][label][0]["rot_err_deg"] < 2.0


def test_hypothesis_sweep(files):
    r = bm.run_hypothesis_sweep(str(files / "s.ply"), str(files / "t.ply"),
                                hypothesis_counts=(256,), thresh_mults=(1.5,),
                                out_json=str(files / "sw.json"), device="cpu")
    j = _jax_keys("benchmark_sweep.json")
    assert set(r) == set(j) and set(r["config"]) == set(j["config"])
    assert set(r["grid"][0]) == set(j["grid"][0])
    assert r["grid"][0]["fitness"] > 0.2


def test_multiway_benchmark(files):
    r = bm.run_multiway_benchmark(3, n_points=4000, out_json=str(files / "mw.json"),
                                  device="cpu")
    j = _jax_keys("benchmark_multiway.json")
    assert set(r) == set(j) and set(r["config"]) == set(j["config"])
    assert r["rot_err_deg_max"] < 2.0


def test_serve_benchmark(files):
    r = bm.run_serve_benchmark(4, n_points=4000, n_distinct=2, clients=2, max_batch=4,
                               ransac_iterations=256, icp_iterations=2, offered_rates=(20,),
                               offered_duration_s=0.3, out_json=str(files / "sv.json"),
                               device="cpu")
    j = _jax_keys("benchmark_serve.json")
    assert set(r) == set(j) and set(r["config"]) == set(j["config"])
    assert set(r["offered_load"][0]) == _expected(j["offered_load"][0],
                                                  _dropped("run_serve_benchmark"))
    assert r["quality_ok"] and r["rot_err_deg_max"] < 2.0


def test_stream_benchmark(files):
    r = bm.run_stream_benchmark(3, n_points=4000, window=2, down_cap=768,
                                ransac_iterations=256, icp_iterations=2, rescue_restarts=0,
                                family="arch", out_json=str(files / "st.json"), device="cpu")
    j = _jax_keys("benchmark_stream.json")
    assert set(r) == _expected(j, _dropped("run_stream_benchmark"))
    assert r["quality_ok"]


def test_overlap_benchmark(files):
    r = bm.run_overlap_benchmark((1.0,), n_points=4000, seeds=2, ransac_iterations=512,
                                 rescue_restarts=1, out_json=str(files / "ov.json"),
                                 device="cpu")
    j = _jax_keys("benchmark_overlap.json")
    assert set(r) == set(j) and set(r["config"]) == set(j["config"])
    assert set(r["families"]) == set(j["families"])
    assert set(r["rows"][0]) == set(j["rows"][0])
    assert set(r["rows"][0]["plain"]) == set(j["rows"][0]["plain"])
    assert r["rows"][0]["plain"]["success_rate_2deg"] == 1.0
    assert r["rows"][0]["rescue"]["success_rate_2deg"] == 1.0


def test_large_cloud_benchmark(files):
    r = bm.run_large_cloud_benchmark(8192, out_json=str(files / "lg.json"), device="cpu")
    j = _jax_keys("benchmark_large.json")
    assert set(r) == set(j) and set(r["config"]) == set(j["config"])
    assert set(r["quality"]) == set(j["quality"])
    assert r["quality"]["align_rmse"] < 0.01


def test_scaling_benchmark(files):
    r = bm.run_scaling_benchmark((1, 2), pairs_per_device=2, n_points=3000,
                                 out_json=str(files / "sc.json"), device="cpu")
    j = _jax_keys("benchmark_scaling.json")
    assert set(r) == set(j) and set(r["config"]) == set(j["config"])
    assert [row["mesh"] for row in r["rows"]] == [1]  # one CPU device
    assert set(r["rows"][0]) == set(j["rows"][0])
    assert r["rows"][0]["min_fitness"] > 0.2


def test_scaling_model_reads_the_kernel_report(files):
    roof = files / "roof.json"
    with pytest.raises(FileNotFoundError):
        bm.run_scaling_model(roofline_json=str(files / "missing.json"), device="cpu")
    roof.write_text(json.dumps({"cases": [{"name": "nn_tiled_16384x16384_d3",
                                           "entries_per_sec": 1.0e12}]}))
    with pytest.raises(ValueError, match="65536x65536_d3"):
        bm.run_scaling_model(roofline_json=str(roof), device="cpu")
    roof.write_text(json.dumps({"cases": [{"name": "nn_tiled_65536x65536_d3",
                                           "entries_per_sec": 1.6e12}]}))
    r = bm.run_scaling_model(roofline_json=str(roof), out_json=str(files / "sm.json"),
                             device="cpu")
    j = _jax_keys("benchmark_scaling_model.json")
    assert set(r) >= _expected(j)
    assert set(r["rows"][0]) == set(j["rows"][0])
    assert r["nn_rate_entries_per_s_measured"] == 1.6e12
    assert r["link_bytes_per_s_per_direction"] == bm.NVLINK_BYTES_PER_S == 450e9
    row = r["rows"][0]
    shard = r["n_points"] // row["mesh"]
    assert row["ring_step_compute_ms"] == round(shard * shard / 1.6e12 * 1e3, 3)
    census = r["collective_census"]
    assert census["pair_dp_batched_register"] == {"shift": 0, "psum": 0, "all_gather": 0}
    assert census["sharded_icp"]["shift"] > 0 and census["sharded_icp"]["psum"] > 0
