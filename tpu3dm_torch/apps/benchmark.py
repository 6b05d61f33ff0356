"""Benchmark runners and their command line (port of tpu3dm/apps/benchmark.py;
reference: benchmark_ransac.py:1-347).

``run_comprehensive_benchmark`` reproduces the reference's phases with
synchronized timing and writes the profiler's table (the reference's
benchmark_results.txt) and a JSON report:

  1. preprocessing (two clouds: downsample, normals, FPFH)    [ref :31-60]
  2. correspondence computation (FPFH NN + mutual filter)     [ref :63-84]
  3. RANSAC iterations, split transform-vs-eval               [ref :87-125]
  4. cloud copy cost (device put/get, the deepcopy analog)    [ref :128-148]
  5. full batched RANSAC pipeline                             [ref :177-202]
  6. N-iteration extrapolation                                [ref :205-220]

The other runners, each JAX's at its widths: the capped/uncapped feature
A/B, the hypothesis sweep, multi-way registration, the serving engine, the
disk-to-result stream, the partial-overlap sweep, the large-cloud path, the
pair-mesh scaling and the ring-ICP scaling model.  Each runs on ``device``
(CUDA unless the caller passes "cpu") and writes its JSON report under
``torch_runs/`` by default, never over the JAX package's files at the root.

Randomness: where JAX passes ``PRNGKey(s)`` a runner seeds a
``torch.Generator`` with s (RANSAC bits, correspondence noise).  Timing:
``torch.cuda.synchronize`` where JAX fences with a host read.

Left out of JAX's reports (``DROPPED_KEYS``): the serving runner's
``latency_p50_pcie_projected_ms`` per offered rate and the stream runner's
``pcie_projected_pairs_per_sec``.  They project the JAX package's remote
host link (``tpu3dm/apps/benchmark.py:658-694, 857-862``) onto a PCIe host;
the card is on such a host already, and the measured numbers stand.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.io.synthetic import make_benchmark_pair
from tpu3dm_torch.ops.ransac_score import score_hypotheses
from tpu3dm_torch.parallel.multipair import draw_bits
from tpu3dm_torch.preprocess.pipeline import (
    load_cloud,
    preprocess_points,
    preprocess_points_batch,
)
from tpu3dm_torch.registration.correspondence import (
    correspondence_noise_draws,
    feature_correspondences,
    gather_pairs,
)
from tpu3dm_torch.registration.hypotheses import sample_distinct_triples
from tpu3dm_torch.registration.kabsch import fit_rigid_horn
from tpu3dm_torch.registration.ransac import chunk_count, ransac_from_correspondences
from tpu3dm_torch.utils.logging import setup_logging
from tpu3dm_torch.utils.profiler import Profiler, fence, profile_block

logger = setup_logging(__name__)

RUNS = Path("torch_runs")
DEFAULT_TXT = str(RUNS / "benchmark_results.txt")
DEFAULT_JSON = str(RUNS / "benchmark_results.json")
# Keys of JAX's reports that the port's do not carry (module docstring):
# (runner, key, where in the report).
DROPPED_KEYS = (
    ("run_serve_benchmark", "latency_p50_pcie_projected_ms", "each offered_load row"),
    ("run_stream_benchmark", "pcie_projected_pairs_per_sec", "the top level"),
)
# The H100 SXM's NVLink 4: 900 GB/s a card, both directions together
# (NVIDIA data sheet), so 450 GB/s each way: the default link of the scaling
# model's ring shift.
NVLINK_BYTES_PER_S = 450e9


def rot_err_deg(T_est, T_true) -> float:
    """Geodesic rotation error (degrees) between two 4x4 (or 3x3) poses."""
    M = _np(T_est)[:3, :3] @ np.asarray(T_true)[:3, :3].T
    return float(np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))))


def rot_errs_deg(T_batch, T_true) -> np.ndarray:
    """Per-lane geodesic rotation errors for a [B, 4, 4] transform batch."""
    M = _np(T_batch)[:, :3, :3] @ np.asarray(T_true)[:3, :3].T
    tr = np.clip((np.trace(M, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(tr))


def _np(x) -> np.ndarray:
    """A host float64 array of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _write(path: str, report: dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(report, indent=2))


def run_comprehensive_benchmark(
    source: str | None,
    target: str | None,
    *,
    voxel_size: float = 0.3,
    noise_ratio: float = 0.0,
    test_iterations: int = 100,
    ransac_iterations: int = 4096,
    out_txt: str = DEFAULT_TXT,
    out_json: str = DEFAULT_JSON,
    device=None,
) -> dict:
    Profiler.reset()
    Profiler.enable()
    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(voxel_size)

    # Phase 1: preprocessing (ref :31-60) ------------------------------------
    # The first span includes the kernels' builds and first loads; warm spans
    # measure what production ingest pays.
    if source and target:
        from tpu3dm_torch.io.ply import read_ply

        with profile_block("preprocessing_total"):
            src = load_cloud(source, cfg.preprocess, device=dev)
            tgt = load_cloud(target, cfg.preprocess, device=dev)
            fence((src, tgt))
        s_pts = read_ply(source)["points"]
        t_pts = read_ply(target)["points"]
    else:
        logger.info("no input files; using the synthetic benchmark pair")
        s_pts, t_pts, _ = make_benchmark_pair(20_000, seed=0, sigma=0.01)
        with profile_block("preprocessing_total"):
            src = preprocess_points(s_pts, cfg.preprocess, device=dev)
            tgt = preprocess_points(t_pts, cfg.preprocess, device=dev)
            fence((src, tgt))
    for _ in range(3):
        with profile_block("preprocessing_warm"):
            src = preprocess_points(s_pts, cfg.preprocess, device=dev)
            tgt = preprocess_points(t_pts, cfg.preprocess, device=dev)
            fence((src, tgt))
    # Batched ingest: both clouds' feature stages in one call, the
    # production multi-cloud path (preprocess_points_batch).
    both = preprocess_points_batch([s_pts, t_pts], cfg.preprocess, device=dev)
    fence(both)
    for _ in range(3):
        with profile_block("preprocessing_batched"):
            both = preprocess_points_batch([s_pts, t_pts], cfg.preprocess, device=dev)
            fence(both)

    # Phase 2: correspondence computation (ref :63-84) -----------------------
    # One set of noise draws, so every call corrupts the same pairs (JAX
    # passes the same key to each).
    draws = correspondence_noise_draws(src.down.capacity, int(src.down.mask.sum()),
                                       int(tgt.down.mask.sum()), torch.Generator().manual_seed(0))

    def correspond():
        return feature_correspondences(src.down, tgt.down, mutual_filter=True,
                                       noise_ratio=noise_ratio, noise_draws=draws)

    for _ in range(3):
        pairs, valid = correspond()
    _sync(dev)
    for _ in range(test_iterations // 10 or 1):
        with profile_block("correspondence_computation"):
            pairs, valid = correspond()
            fence(pairs)
    p_all, q_all = gather_pairs(src.down, tgt.down, pairs)

    # Phase 3: RANSAC iteration cost, split (ref :87-125).  One reference
    # "iteration" = fit ONE hypothesis + evaluate it; here a batch of
    # `ransac_iterations` hypotheses is one call, so the comparable
    # per-iteration number is batch_time / ransac_iterations.  Triples are
    # drawn over every row, valid or not, as JAX's phase draws them.
    n = p_all.shape[0]
    bits = draw_bits((ransac_iterations, 2), torch.Generator().manual_seed(0)).to(dev)

    def k_fit():
        triples = sample_distinct_triples(bits, n)
        return fit_rigid_horn(p_all[triples], q_all[triples])

    thresh_sq = cfg.ransac.dist_thresh**2

    def k_eval(T):
        return score_hypotheses(T[:, :3, :3], T[:, :3, 3], p_all, q_all, valid, thresh_sq)

    T_batch = k_fit()
    counts = k_eval(T_batch)
    _sync(dev)
    for _ in range(test_iterations):
        with profile_block("ransac_transform_batch"):
            T_batch = k_fit()
            fence(T_batch)
        with profile_block("ransac_inlier_eval_batch"):
            counts = k_eval(T_batch)
            fence(counts)

    # Phase 4: cloud copy cost (ref deepcopy benchmark :128-148) -------------
    for _ in range(test_iterations):
        with profile_block("cloud_device_roundtrip"):
            host = src.down.points.cpu().numpy()
            back = torch.as_tensor(host, device=dev)
            fence(back)

    # Phase 5: full RANSAC pipeline (ref :177-202) ---------------------------
    batch = min(4096, ransac_iterations)
    full_bits = draw_bits((chunk_count(ransac_iterations, batch), batch, 2),
                          torch.Generator().manual_seed(0))

    def full():
        return ransac_from_correspondences(
            p_all, q_all, valid, full_bits, dist_thresh=cfg.ransac.dist_thresh,
            max_iterations=ransac_iterations, batch_size=batch,
        )

    res = full()
    _sync(dev)
    for _ in range(max(test_iterations // 10, 3)):
        with profile_block("full_ransac_pipeline"):
            res = full()
            fence(res.transformation)
    logger.info(
        "full RANSAC: fitness=%.4f inlier_rmse=%.4f iters=%d",
        float(res.fitness), float(res.inlier_rmse), int(res.iterations),
    )

    # Phase 6: extrapolation to 10k iterations (ref :205-220) ----------------
    stats = Profiler.get_stats()
    batch_ms = stats["ransac_transform_batch"].avg + stats["ransac_inlier_eval_batch"].avg
    per_iter_ms = batch_ms / ransac_iterations * 1e3
    est_10k_s = per_iter_ms * 10_000 / 1e3
    logger.info(
        "per-hypothesis cost %.4f ms -> 10k-iteration estimate %.3f s "
        "(reference CPU: 0.757 ms/iter -> 7.6 s)",
        per_iter_ms, est_10k_s,
    )

    Profiler.print_report()
    Path(out_txt).parent.mkdir(parents=True, exist_ok=True)
    Profiler.save_report(out_txt)
    report = {
        "config": {
            "voxel_size": voxel_size,
            "noise_ratio": noise_ratio,
            "ransac_iterations": ransac_iterations,
            "backend": dev.type,
        },
        "quality": {
            "ransac_fitness": float(res.fitness),
            "ransac_inlier_rmse": float(res.inlier_rmse),
        },
        "derived": {
            "per_hypothesis_ms": per_iter_ms,
            "est_10k_iterations_s": est_10k_s,
            "hypotheses_per_sec": 1e3 / per_iter_ms if per_iter_ms else None,
            # Reference CPU: 791.23 ms for the same two-cloud preprocess
            # (benchmark_results.txt:6).  Warm = production cost after the
            # first use; batched = both clouds' features in one call.
            "preprocess_warm_ms_2clouds": stats["preprocessing_warm"].avg,
            "preprocess_batched_ms_2clouds": stats["preprocessing_batched"].avg,
        },
        "spans": {k: v.as_dict() for k, v in stats.items()},
    }
    _write(out_json, report)
    logger.info("wrote %s and %s", out_txt, out_json)
    return report


def run_fpfh_ab_benchmark(
    *,
    n_points: int = 12_000,
    seeds: tuple[int, ...] = (0, 1, 2),
    voxel_size: float = 0.3,
    out_json: str = str(RUNS / "benchmark_fpfh_ab.json"),
    device=None,
) -> dict:
    """A/B: capped (Open3D-parity, max_nn 30/100) vs uncapped feature paths.

    Reports RANSAC fitness, final rotation error and preprocess wall time
    for both configurations over several synthetic pairs (``register_pair``,
    its default generator seeded 0).
    """
    import dataclasses

    from tpu3dm_torch.registration.pipeline import register_pair

    dev = resolve_device(device)
    results = {}
    for label, (n_cap, f_cap) in (
        ("capped", (30, 100)),
        ("uncapped", (0, 0)),
    ):
        cfg = PipelineConfig.with_voxel_size(voxel_size)
        cfg = dataclasses.replace(
            cfg,
            preprocess=dataclasses.replace(
                cfg.preprocess, normal_max_nn=n_cap, fpfh_max_nn=f_cap
            ),
        )
        rows = []
        for seed in seeds:
            src_pts, tgt_pts, T_true = make_benchmark_pair(n_points, seed=seed, sigma=0.01)
            t0 = time.time()
            src = preprocess_points(src_pts, cfg.preprocess, device=dev)
            tgt = preprocess_points(tgt_pts, cfg.preprocess, device=dev)
            fence((src, tgt))
            t_pre = time.time() - t0
            out = register_pair(src, tgt, cfg)
            rot = rot_err_deg(out.icp.transformation, T_true)
            rows.append(
                {
                    "seed": seed,
                    "ransac_fitness": round(float(out.ransac.fitness), 4),
                    "icp_fitness": round(float(out.icp.fitness), 4),
                    "rot_err_deg": round(rot, 4),
                    "preprocess_s": round(t_pre, 3),
                }
            )
        results[label] = rows
        logger.info(
            "%s: ransac fitness %s, rot err %s deg",
            label,
            [r["ransac_fitness"] for r in rows],
            [r["rot_err_deg"] for r in rows],
        )
    report = {
        "benchmark": "fpfh_capped_vs_uncapped",
        "n_points": n_points,
        "voxel_size": voxel_size,
        "configs": {
            "capped": {"normal_max_nn": 30, "fpfh_max_nn": 100},
            "uncapped": {"normal_max_nn": 0, "fpfh_max_nn": 0},
        },
        "results": results,
    }
    _write(out_json, report)
    logger.info("wrote %s", out_json)
    return report


def run_hypothesis_sweep(
    source: str | None,
    target: str | None,
    *,
    voxel_size: float = 0.3,
    hypothesis_counts: tuple[int, ...] = (1024, 4096, 16384, 65536),
    thresh_mults: tuple[float, ...] = (0.75, 1.5, 3.0),
    out_json: str = str(RUNS / "benchmark_sweep.json"),
    device=None,
) -> dict:
    """Batched-RANSAC sweep: hypothesis counts x inlier-threshold grid
    (BASELINE.json config 3).  Reports wall time, throughput and quality per
    grid point; early stop is disabled (confidence 1.0) to measure the full
    budget.  Each call draws fresh bits (JAX: ``fold_in(key, r)``)."""
    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(voxel_size)
    if source and target:
        src = load_cloud(source, cfg.preprocess, device=dev)
        tgt = load_cloud(target, cfg.preprocess, device=dev)
    else:
        logger.info("no input files; using the synthetic benchmark pair")
        s_pts, t_pts, _ = make_benchmark_pair(20_000, seed=0, sigma=0.01)
        src = preprocess_points(s_pts, cfg.preprocess, device=dev)
        tgt = preprocess_points(t_pts, cfg.preprocess, device=dev)

    pairs, valid = feature_correspondences(src.down, tgt.down, mutual_filter=True)
    p_all, q_all = gather_pairs(src.down, tgt.down, pairs)
    _sync(dev)

    grid = []
    gen = torch.Generator().manual_seed(0)
    for k_hyp in hypothesis_counts:
        batch = min(4096, k_hyp)
        for mult in thresh_mults:
            thresh = mult * voxel_size

            def fn(_t=thresh, _k=k_hyp, _b=batch):
                bits = draw_bits((chunk_count(_k, _b), _b, 2), gen)
                return ransac_from_correspondences(
                    p_all, q_all, valid, bits, dist_thresh=_t, max_iterations=_k,
                    batch_size=_b, confidence=1.0,  # no early stop: the full batch
                )

            res = fn()  # first run
            _sync(dev)
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                res = fn()
            _sync(dev)
            dt = (time.perf_counter() - t0) / reps
            point = {
                "hypotheses": k_hyp,
                "dist_thresh": thresh,
                "time_s": dt,
                "hypotheses_per_sec": k_hyp / dt,
                "fitness": float(res.fitness),
                "inlier_rmse": float(res.inlier_rmse),
            }
            grid.append(point)
            logger.info(
                "sweep K=%d thresh=%.3f: %.1f ms, %.3g hyp/s, fitness=%.3f",
                k_hyp, thresh, dt * 1e3, k_hyp / dt, float(res.fitness),
            )

    report = {
        "config": {"voxel_size": voxel_size, "backend": dev.type},
        "grid": grid,
    }
    _write(out_json, report)
    logger.info("wrote %s (%d grid points)", out_json, len(grid))
    return report


def multiway_views(n_clouds: int, n_points: int) -> tuple[list[np.ndarray], np.ndarray]:
    """JAX's multi-way data (``tpu3dm/apps/benchmark.py:400-428``): view k is
    ``dental_arch_cloud(n_points, seed=0)`` under rand_T(k) (the reference's
    test magnitude: 30 deg, 0.5; view 0 under the identity) plus sigma 0.01
    noise, one generator seeded 0 across the views.  Returns (views, trues
    [n, 4, 4])."""
    from tpu3dm_torch.io.synthetic import dental_arch_cloud

    rng = np.random.default_rng(0)
    base = dental_arch_cloud(n_points, seed=0)
    center = base.mean(axis=0)

    def rand_T(k):
        r = np.random.default_rng(1000 + k)
        a, b, c = r.uniform(-np.pi / 6, np.pi / 6, size=3)
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        R = rz @ ry @ rx
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ center + center + r.uniform(-0.5, 0.5, size=3)
        return T

    trues = np.stack([np.eye(4)] + [rand_T(k) for k in range(1, n_clouds)])
    views = [(base @ T[:3, :3].T + T[:3, 3] + 0.01 * rng.standard_normal(base.shape))
             .astype(np.float32) for T in trues]
    return views, trues


def run_multiway_benchmark(
    n_clouds: int = 16,
    *,
    n_points: int = 20_000,
    rescue_restarts: int = 2,
    robust_delta: float = 0.1,
    out_json: str = str(RUNS / "benchmark_multiway.json"),
    device=None,
) -> dict:
    """Multi-way registration benchmark (BASELINE config 5).

    N synthetic views of one cloud under known rigid transforms; all
    chain + loop-closure edges registered in chunked batched calls
    (``register_multiway_batched``), then the pose-graph Gauss-Newton solve
    (edgewise above 64 nodes), with the alias rescue per edge and the
    Geman-McClure robust pose loss.  Reports edges/s (warm, median of 3
    calls on the same bits) and per-edge rotation error against the truth.
    """
    from tpu3dm_torch.multiway.posegraph import default_edges, register_multiway_batched

    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(0.3)
    views, trues = multiway_views(n_clouds, n_points)
    # The batched fan-out registers the DOWNSAMPLED clouds only.
    clouds = preprocess_points_batch(views, cfg.preprocess, full_normals=False, device=dev)
    edges = default_edges(n_clouds)

    def call():
        return register_multiway_batched(
            clouds, cfg, generator=torch.Generator().manual_seed(0),
            rescue_restarts=rescue_restarts, robust_delta=robust_delta, device=dev)

    out = call()  # first call: builds and first loads
    times = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        out = call()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    warm_s = float(np.median(times))

    # Per-edge quality: estimated T_ij vs ground-truth view_j <- view_i.
    rot_errs = []
    for (i, j), T_est in zip(edges, out.edge_transforms):
        Ti, Tj = trues[i], trues[j]
        T_true = np.eye(4)
        T_true[:3, :3] = Tj[:3, :3] @ Ti[:3, :3].T
        T_true[:3, 3] = Tj[:3, 3] - T_true[:3, :3] @ Ti[:3, 3]
        rot_errs.append(rot_err_deg(T_est, T_true))
    report = {
        "config": {"n_clouds": n_clouds, "n_points": n_points,
                   "edges": len(edges), "backend": dev.type},
        "warm_s": warm_s,
        "edges_per_sec": len(edges) / warm_s,
        "rot_err_deg_mean": float(np.mean(rot_errs)),
        "rot_err_deg_max": float(np.max(rot_errs)),
        "min_edge_fitness": float(np.min(out.edge_fitness)),
    }
    _write(out_json, report)
    logger.info(
        "multiway %d clouds / %d edges: %.0f ms warm (%.1f edges/s), "
        "rot err mean %.3f deg max %.3f deg",
        n_clouds, len(edges), warm_s * 1e3, report["edges_per_sec"],
        report["rot_err_deg_mean"], report["rot_err_deg_max"],
    )
    return report


def run_serve_benchmark(
    n_requests: int = 512,
    *,
    n_points: int = 20_000,
    n_distinct: int = 8,
    clients: int = 8,
    max_batch: int = 256,
    max_delay_ms: float = 5.0,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    overlap_ab: bool = False,
    offered_rates: tuple = (50, 150, 250),
    offered_duration_s: float = 8.0,
    out_json: str = str(RUNS / "benchmark_serve.json"),
    device=None,
) -> dict:
    """Online-serving benchmark: sustained requests/s through the
    micro-batching engine (serve/engine.py).

    ``clients`` threads submit ``n_requests`` single-pair requests (round-
    robin over ``n_distinct`` preprocessed pairs) into ONE ServeEngine.
    Reports: the first request's latency after the prewarm, sustained
    request throughput, achieved batch sizes, per-request latency
    percentiles split into queue / pack / device (synchronized uploads, so
    pack holds the upload), shed counts, latency at offered Poisson rates
    below saturation, and a per-request quality check.  ``overlap_ab=True``
    also measures the other pipeline_depth for an A/B.
    """
    import dataclasses as _dc
    import threading

    from tpu3dm_torch.core.cloud import round_up
    from tpu3dm_torch.serve import ServeConfig, ServeEngine
    from tpu3dm_torch.serve.engine import EngineOverloaded

    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(0.3)
    raw, trues = [], []
    for s in range(n_distinct):
        sp, tp, tt = make_benchmark_pair(n_points, seed=s, sigma=0.01)
        raw.extend([sp, tp])
        trues.append(tt)
    t0 = time.time()
    procs = preprocess_points_batch(raw, cfg.preprocess, full_normals=False, device=dev)
    _sync(dev)
    logger.info("serve bench: ingested %d clouds in %.1fs", len(raw), time.time() - t0)
    pairs = [(procs[i], procs[i + 1]) for i in range(0, len(procs), 2)]

    serve_cfg = ServeConfig(
        max_batch=max_batch,
        max_delay_ms=max_delay_ms,
        ransac_iterations=ransac_iterations,
        icp_iterations=icp_iterations,
        fence_uploads=True,  # an honest pack / device split in the report
    )
    # Steady-state capacity buckets of this workload, for the prewarm.
    caps = sorted({
        round_up(max(int(s_.down.mask.sum()), int(t_.down.mask.sum()), 1),
                 serve_cfg.bucket_multiple)
        for s_, t_ in pairs
    })

    def flood_once(engine) -> tuple[float, list]:
        results: list = [None] * n_requests
        errors: list = []

        def client(cid: int) -> None:
            try:
                futs = []
                for r in range(cid, n_requests, clients):
                    futs.append((r, engine.submit(*pairs[r % n_distinct])))
                for r, f in futs:
                    results[r] = f.result(timeout=1200)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        if errors:
            raise errors[0]
        return wall, results

    def run_flood(engine) -> tuple[float, list, dict]:
        """One untimed pass warms every micro-batch shape the flood
        produces, then the timed pass measures warm throughput."""
        wall0, _ = flood_once(engine)
        logger.info("flood warm pass: %.1fs", wall0)
        engine.reset_latency_window()
        wall, results = flood_once(engine)
        return wall, results, engine.stats()

    engine = ServeEngine(cfg, serve_cfg, device=dev)
    try:
        # batch size 1 covers the lone first request; max_batch the
        # steady-state group.
        prewarm_s = engine.prewarm(caps=caps, batch_sizes=[1, max_batch])
        first = engine.register(*pairs[0], timeout=1200)
        first_request_ms = first.latency_ms
        logger.info(
            "prewarm %.1fs (caps %s), first request after prewarm: %.0f ms",
            prewarm_s, caps, first_request_ms,
        )
        wall, results, engine_stats = run_flood(engine)

        # --- offered-load latency: p50/p95 BELOW saturation ---------------
        # The flood saturates the engine, which measures capacity, not the
        # latency a serving user sees.  Here requests arrive as a Poisson
        # process at fixed offered rates.
        offered_rows = []
        rng = np.random.default_rng(42)
        # Every power-of-two micro-batch size Poisson arrivals form, warmed
        # up front.
        pow2 = []
        b = 1
        while b <= max_batch:
            pow2.append(b)
            b *= 2
        t0 = time.time()
        engine.prewarm(caps=caps, batch_sizes=pow2)
        logger.info("offered-load shape prewarm (%s): %.1fs", pow2, time.time() - t0)

        def offer(rate, duration):
            futs, shed, i = [], 0, 0
            t0 = time.time()
            next_t = t0
            t_end = t0 + duration
            while True:
                now = time.time()
                if now >= t_end:
                    break
                if now < next_t:
                    time.sleep(min(next_t - now, 0.02))
                    continue
                # A real client sheds at overload; count it, keep offering.
                try:
                    futs.append(engine.submit(*pairs[i % n_distinct]))
                except EngineOverloaded:
                    shed += 1
                i += 1
                next_t += rng.exponential(1.0 / rate)
            for f in futs:
                f.result(timeout=1200)
            return futs, shed

        for rate in offered_rates:
            offer(rate, min(offered_duration_s, 4.0))  # untimed warm pass
            engine.reset_latency_window()
            futs, shed = offer(rate, offered_duration_s)
            st = engine.stats()
            lat = st.get("latency_ms") or {}
            que = st.get("queue_ms") or {}
            pack = st.get("pack_ms_per_batch") or {}
            dev_ms = st.get("device_ms_per_batch") or {}
            mb = float(st.get("mean_batch_size") or 1.0)
            offered_rows.append({
                "offered_req_per_sec": rate,
                "achieved_req_per_sec": round(len(futs) / offered_duration_s, 1),
                "requests": len(futs),
                "shed": shed,
                "latency_ms": {k: round(v, 1) for k, v in lat.items()},
                "queue_ms": {k: round(v, 1) for k, v in que.items()},
                "pack_ms_per_batch": {k: round(v, 1) for k, v in pack.items()},
                "device_ms_per_batch": {k: round(v, 1) for k, v in dev_ms.items()},
                "mean_batch_size": round(mb, 1),
            })
            logger.info(
                "offered %d req/s: p50 %.0f ms, p95 %.0f ms (queue p50 %.0f, "
                "pack p50 %.0f, device p50 %.0f)",
                rate, lat.get("p50", 0), lat.get("p95", 0), que.get("p50", 0),
                pack.get("p50", 0), dev_ms.get("p50", 0),
            )
    finally:
        engine.close()

    baseline = None
    if overlap_ab:
        # A/B: the same flood with the OTHER pipeline mode.
        other = 1 - (serve_cfg.pipeline_depth > 0)
        eng0 = ServeEngine(cfg, _dc.replace(serve_cfg, pipeline_depth=other), device=dev)
        try:
            warm = [eng0.submit(*pairs[i % n_distinct]) for i in range(max_batch)]
            for f in warm:
                f.result(timeout=1200)
            eng0.reset_latency_window()
            wall0, _, stats0 = run_flood(eng0)
            baseline = {
                "pipeline_depth": other,
                "requests_per_sec": round(n_requests / wall0, 1),
                "latency_ms": stats0.get("latency_ms"),
            }
        finally:
            eng0.close()

    rot_errs = [rot_err_deg(res.transformation, trues[r % n_distinct])
                for r, res in enumerate(results)]
    report = {
        "requests": n_requests,
        "clients": clients,
        "requests_per_sec": round(n_requests / wall, 1),
        "wall_s": round(wall, 2),
        "prewarm_s": round(prewarm_s, 1),
        "first_request_after_prewarm_ms": round(first_request_ms, 1),
        "mean_batch_size": round(engine_stats["mean_batch_size"], 1),
        "max_batch_size": engine_stats["max_batch_size"],
        "shared_target_requests": engine_stats.get("shared_target_requests"),
        "resident_targets": engine_stats.get("resident_targets"),
        "shed": engine_stats.get("shed"),
        "latency_ms": engine_stats.get("latency_ms"),
        "queue_ms": engine_stats.get("queue_ms"),
        "pack_ms_per_batch": engine_stats.get("pack_ms_per_batch"),
        "device_ms_per_batch": engine_stats.get("device_ms_per_batch"),
        "pipeline_depth": serve_cfg.pipeline_depth,
        "pipeline_ab_variant": baseline,
        "offered_load": offered_rows,
        "prewarm_parallel": 4,
        "rot_err_deg_max": round(max(rot_errs), 3),
        "quality_ok": max(rot_errs) < 2.0,
        "config": {
            "max_batch": max_batch,
            "max_delay_ms": max_delay_ms,
            "ransac_iterations": ransac_iterations,
            "icp_iterations": icp_iterations,
            "n_points": n_points,
            "fence_uploads": True,
        },
        "backend": dev.type,
    }
    _write(out_json, report)
    logger.info(
        "serve bench: %.1f req/s (mean batch %.1f, rot_err max %.3f deg, "
        "first-req %.0f ms%s) -> %s",
        report["requests_per_sec"], report["mean_batch_size"],
        report["rot_err_deg_max"], first_request_ms,
        (f", depth-{baseline['pipeline_depth']} variant "
         f"{baseline['requests_per_sec']} req/s" if baseline else ""),
        out_json,
    )
    return report


def run_stream_benchmark(
    n_pairs: int = 384,
    *,
    n_points: int = 20_000,
    window: int = 128,
    down_cap: int = 896,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    rescue_restarts: int = 3,
    generic_ab: bool = False,
    family: str = "mix",
    out_json: str = str(RUNS / "benchmark_stream.json"),
    device=None,
) -> dict:
    """Disk->result streaming benchmark: gated fresh-pairs/s.

    Writes a manifest of never-seen synthetic PLYs to a temporary
    directory, streams it through the fused ingest+register pipeline
    (registration/stream.py) and reports steady-state fresh-pairs/s with the
    per-pair quality gate and the host-ingest and device-only rates.
    ``generic_ab=True`` also measures the generic path (separate feature and
    registration calls).  Reference role: preprocessing as phase 1 of the
    comprehensive benchmark (benchmark_ransac.py:31-60,223-280), fused here
    with registration.
    """
    import shutil
    import tempfile

    from tpu3dm_torch.registration.stream import (
        make_stream_manifest,
        measure_fused_device_rate,
        stream_quality,
        stream_register_pairs,
    )

    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(0.3)
    tmp = tempfile.mkdtemp(prefix="tpu3dm_torch_streambench_")
    try:
        t0 = time.time()
        pair_paths, trues, moments = make_stream_manifest(
            tmp, n_pairs, n_points=n_points, sigma=0.01, family=family
        )
        manifest_s = time.time() - t0
        kw = dict(
            window=window, down_cap=down_cap,
            ransac_iterations=ransac_iterations,
            icp_iterations=icp_iterations,
            rescue_restarts=rescue_restarts,
            device=dev,
        )
        res = stream_register_pairs(
            pair_paths, cfg, fuse_device=True, retry_measure_warm=True, **kw
        )
        q = stream_quality(res, trues, moments)
        device_rate = measure_fused_device_rate(
            cfg, window=window, down_cap=down_cap,
            ransac_iterations=ransac_iterations,
            icp_iterations=icp_iterations,
            rescue_restarts=rescue_restarts,
            device=dev,
        )
        ingest_med = float(np.median(res.ingest_seconds)) if res.ingest_seconds else None
        host_rate = (window / ingest_med) if ingest_med else None
        report = {
            "manifest_pairs": n_pairs,
            "n_points": n_points,
            "window": window,
            "down_cap": down_cap,
            "manifest_write_s": round(manifest_s, 1),
            "fresh_pairs_per_sec": round(
                res.steady_pairs_per_sec or res.fresh_pairs_per_sec, 2
            ),
            "fresh_pairs_per_sec_incl_compile": round(res.fresh_pairs_per_sec, 2),
            "window_done_s": [round(s, 3) for s in res.window_done_s],
            "host_ingest_s_per_window": (
                [round(s, 3) for s in res.ingest_seconds] or None
            ),
            "host_ingest_pairs_per_sec": round(host_rate, 1) if host_rate else None,
            "device_only_pairs_per_sec": round(device_rate, 1),
            "rescue_restarts": rescue_restarts,
            "retry_pairs": len(res.retry_pairs),
            "retry_seconds": round(res.retry_seconds, 2),
            **q,
            "backend": dev.type,
        }
        if generic_ab:
            res_g = stream_register_pairs(pair_paths, cfg, **kw)
            q_g = stream_quality(res_g, trues, moments)
            report["generic_path"] = {
                "fresh_pairs_per_sec": round(
                    res_g.steady_pairs_per_sec or res_g.fresh_pairs_per_sec, 2
                ),
                "fresh_pairs_per_sec_incl_compile": round(res_g.fresh_pairs_per_sec, 2),
                "quality_ok": q_g["quality_ok"],
            }
        _write(out_json, report)
        logger.info(
            "stream bench: %.1f fresh pairs/s steady (%.1f incl. first use), "
            "rot_max %.3f deg, ok=%s -> %s",
            report["fresh_pairs_per_sec"],
            report["fresh_pairs_per_sec_incl_compile"],
            report["rot_err_deg_worst_pair"], report["quality_ok"], out_json,
        )
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_overlap_benchmark(
    overlaps: tuple = (1.0, 0.8, 0.6, 0.5, 0.4),
    *,
    n_points: int = 20_000,
    seeds: int = 32,
    voxel_size: float = 0.3,
    ransac_iterations: int = 4096,
    rescue_restarts: int = 2,
    out_json: str = str(RUNS / "benchmark_overlap.json"),
    device=None,
) -> dict:
    """Partial-overlap robustness sweep (the reference's trim_ply scenario,
    BASELINE config 2) with an alias-rescue A/B, over three geometry
    families: the dental arch, the CAD plate-with-holes and the arch scan.

    For each (family, overlap) the target is cropped to that fraction of the
    source's extent before the ground-truth transform; ``seeds`` RANSAC bit
    sets (one a pair, drawn from a generator seeded round(overlap * 1000);
    JAX splits ``PRNGKey(round(overlap * 1000))``) register the same pair in
    one batched call.  Reports per overlap, for the plain fused step and with
    ``rescue_restarts``: median/max rotation error, median fitness and the
    fraction of seeds within 2 degrees.
    """
    from tpu3dm_torch.registration.batch import register_pairs_batched

    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(voxel_size)
    families = {}
    for family in ("arch", "plate", "scan"):
        rows = []
        for ov in overlaps:
            src, tgt, T_true = make_benchmark_pair(
                n_points, seed=17, overlap=ov, sigma=0.01, family=family
            )
            ps, pt = preprocess_points_batch(
                [src, tgt], cfg.preprocess, full_normals=False, device=dev
            )
            pairs = [(ps, pt)] * seeds
            row = {"overlap": ov}
            for tag, rr in (("plain", 0), ("rescue", rescue_restarts)):
                # round(), not int(): 0.7 * 1000 is 699.999...
                res = register_pairs_batched(
                    pairs, cfg, generator=torch.Generator().manual_seed(round(ov * 1000)),
                    ransac_iterations=ransac_iterations, rescue_restarts=rr, device=dev,
                )
                errs = rot_errs_deg(res.transforms, T_true)
                row[tag] = {
                    "rot_err_deg_median": round(float(np.median(errs)), 3),
                    "rot_err_deg_max": round(float(errs.max()), 3),
                    "fitness_median": round(float(np.median(res.ransac_fitness)), 3),
                    "success_rate_2deg": round(float((errs < 2.0).mean()), 3),
                }
            rows.append(row)
            logger.info(
                "%s overlap %.2f: plain %.0f%% ok (med %.3f deg) | rescue %.0f%% ok "
                "(med %.3f deg)",
                family, ov,
                100 * row["plain"]["success_rate_2deg"],
                row["plain"]["rot_err_deg_median"],
                100 * row["rescue"]["success_rate_2deg"],
                row["rescue"]["rot_err_deg_median"],
            )
        families[family] = rows
    report = {
        "rows": families["arch"],
        "families": families,
        "config": {
            "n_points": n_points, "seeds": seeds,
            "voxel_size": voxel_size,
            "ransac_iterations": ransac_iterations,
            "rescue_restarts": rescue_restarts,
        },
        "backend": dev.type,
    }
    _write(out_json, report)
    logger.info("overlap sweep -> %s", out_json)
    return report


def run_large_cloud_benchmark(
    n_points: int = 1_048_576,
    *,
    block: int = 512,
    w: int = 8,
    out_json: str = str(RUNS / "benchmark_large.json"),
    device=None,
) -> dict:
    """Large-cloud benchmark (BASELINE config 4): block-sparse NN latency,
    ICP per-iteration cost and full pipeline time at ``n_points``."""
    from tpu3dm_torch.ops.nn_sparse import nn_blocksparse
    from tpu3dm_torch.registration.large import (
        icp_refine_large,
        prepare_large_cloud,
        register_arrays_large,
    )

    dev = resolve_device(device)
    src_pts, tgt_pts, T_true = make_benchmark_pair(n_points, seed=0, sigma=0.002)
    src = prepare_large_cloud(src_pts, block=block, device=dev)
    tgt = prepare_large_cloud(tgt_pts, block=block, device=dev)
    _sync(dev)

    def sync_time(fn, reps=3):
        fn()
        _sync(dev)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    nn_s = sync_time(lambda: nn_blocksparse(src.points, tgt.points, block=block, w=w))

    T0g = np.asarray(T_true).copy()
    T0g[:3, 3] += 0.05
    icp_s = sync_time(
        lambda: icp_refine_large(
            src, tgt, T0g, dist_thresh=0.12, max_iterations=10, w=w,
            point_to_plane=False,
        ),
        reps=2,
    )

    t0 = time.perf_counter()
    fine, _ = register_arrays_large(src_pts, tgt_pts, device=dev)
    T = fine.transformation.cpu().numpy().astype(np.float64)
    full_s = time.perf_counter() - t0
    moved = src_pts @ T[:3, :3].T + T[:3, 3]
    expect = src_pts @ np.asarray(T_true)[:3, :3].T + np.asarray(T_true)[:3, 3]
    rmse = float(np.sqrt(((moved - expect) ** 2).sum(1).mean()))

    report = {
        "config": {"n_points": n_points, "block": block, "w": w, "backend": dev.type},
        "nn_search_s": nn_s,
        "icp_10iter_s": icp_s,
        "icp_ms_per_iter": icp_s * 100.0,
        "full_register_s": full_s,
        "quality": {"fitness": float(fine.fitness), "align_rmse": rmse},
    }
    _write(out_json, report)
    logger.info(
        "large-cloud %d pts: NN %.0f ms, ICP %.0f ms/iter, full %.1f s, rmse %.5f",
        n_points, nn_s * 1e3, icp_s * 100.0, full_s, rmse,
    )
    return report


def _stack_down(clouds, cap: int, n_pairs: int) -> list[torch.Tensor]:
    """The pairs' down clouds padded to ``cap`` and tiled to ``n_pairs``:
    source then target points, features, mask, normals (host tensors)."""
    n_src = len(clouds)
    reps = -(-n_pairs // n_src)

    def stack(attr, which):
        rows = []
        for c in clouds:
            x = getattr(c[which].down, attr).cpu()
            pad = torch.zeros((cap - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype)
            rows.append(torch.cat([x, pad]))
        base = torch.stack(rows)
        return base.repeat((reps,) + (1,) * (base.ndim - 1))[:n_pairs].contiguous()

    attrs = ("points", "features", "mask", "normals")
    return [stack(a, 0) for a in attrs] + [stack(a, 1) for a in attrs]


def run_scaling_benchmark(
    mesh_sizes: tuple[int, ...] = (1, 2, 4, 8),
    *,
    pairs_per_device: int = 64,
    n_points: int = 20_000,
    out_json: str = str(RUNS / "benchmark_scaling.json"),
    device=None,
) -> dict:
    """Cloud-pairs/s scaling over growing pair meshes.

    Each mesh size n (at most the device count: the CUDA cards, or one CPU)
    registers ``pairs_per_device * n`` preprocessed pairs with
    ``parallel.register.batched_register``; efficiency(n) =
    pairs_per_sec(n) / (n * pairs_per_sec(1)).  Each pair takes its own bits
    (JAX: ``split(PRNGKey(0), P)``), drawn from a generator seeded 0.
    """
    from tpu3dm_torch.parallel.mesh import make_mesh
    from tpu3dm_torch.parallel.register import batched_register
    from tpu3dm_torch.registration.batch import pair_bits_shape

    dev = resolve_device(device)
    cfg = PipelineConfig.with_voxel_size(0.3)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    sizes = [n for n in mesh_sizes if n <= len(devices)]
    if not sizes:
        raise RuntimeError(f"no usable mesh sizes from {mesh_sizes} on {len(devices)} devices")

    # Distinct preprocessed pairs, stacked to one capacity.
    n_src_pairs = 8
    raw = []
    for s in range(n_src_pairs):
        sp, tp, _ = make_benchmark_pair(n_points, seed=s, sigma=0.01)
        raw.extend([sp, tp])
    procs = preprocess_points_batch(raw, cfg.preprocess, device=dev)
    clouds = [(procs[i], procs[i + 1]) for i in range(0, len(procs), 2)]
    cap = max(max(c[0].down.capacity, c[1].down.capacity) for c in clouds)

    rows = []
    base_rate = None
    for n in sizes:
        mesh = make_mesh(n, 1, devices=devices[:n])
        P_ = pairs_per_device * n
        arrays = [a.to(devices[0]) for a in _stack_down(clouds, cap, P_)]
        bits = draw_bits((P_,) + pair_bits_shape(cap)[0], torch.Generator().manual_seed(0))

        def run():
            return batched_register(
                mesh, *arrays, bits,
                dist_thresh=float(cfg.ransac.dist_thresh),
                icp_thresh=float(cfg.icp.dist_thresh),
            )

        out = run()
        _sync(devices[0])
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            for d in devices[:n]:
                _sync(d)
            ts.append(time.perf_counter() - t0)
        rate = P_ / min(ts)
        if base_rate is None:
            base_rate = rate
        eff = rate / (n * base_rate)
        rows.append(
            {"mesh": n, "pairs": P_, "time_s": min(ts),
             "pairs_per_sec": rate, "efficiency": eff,
             "min_fitness": float(out[1].min())}
        )
        logger.info("scaling mesh=%d: %.1f pairs/s, efficiency %.2f", n, rate, eff)

    report = {
        "config": {"pairs_per_device": pairs_per_device, "n_points": n_points,
                   "cap": cap, "backend": dev.type, "devices": len(devices)},
        "rows": rows,
    }
    if dev.type == "cpu":
        report["note"] = (
            "One CPU device: the run checks the sharded program and its "
            "results; scaling is measured only across several cards."
        )
    _write(out_json, report)
    logger.info("wrote %s", out_json)
    return report


def _kernel_nn_rate(roofline_json: str) -> float:
    """entries/s of kernel 4's 65536^2 d = 3 case in the port's kernel
    report (apps/kernelbench.py); raises when the report or the case is
    missing."""
    path = Path(roofline_json)
    if not path.exists():
        raise FileNotFoundError(
            f"{path}: no kernel report; run `tpu3dm-torch kernels --out {path}` on the card first")
    roof = json.loads(path.read_text())
    for case in roof.get("cases", []):
        if case["name"].startswith("nn_tiled_") and case["name"].endswith("_65536x65536_d3"):
            if not case.get("entries_per_sec"):
                break
            return float(case["entries_per_sec"])
    raise ValueError(f"{path}: no timed nn_tiled_65536x65536_d3 case (run the full case list)")


def run_scaling_model(
    *,
    n_points: int = 1_048_576,
    mesh_sizes: tuple[int, ...] = (2, 4, 8, 16, 64),
    roofline_json: str = str(RUNS / "kernel_roofline.json"),
    link_bytes_per_s: float = NVLINK_BYTES_PER_S,
    out_json: str = str(RUNS / "benchmark_scaling_model.json"),
    device=None,
) -> dict:
    """Model of the ring-NN / sharded-ICP axis across cards, and a census of
    the collectives the sharded programs call.

      1. Model: per ring step each device searches a dense [N/nb, N/nb]
         block (time from the port's MEASURED kernel-4 rate, the
         ``nn_tiled_65536x65536_d3`` case of ``roofline_json``) and shifts
         its resident target shard (points + normals + mask = 25 B/point)
         over one link of ``link_bytes_per_s`` each way (default: the H100
         SXM's published NVLink rate).  Without overlap, efficiency =
         t_compute / (t_compute + t_comm); compute grows as shard^2 and
         communication as shard.
      2. Census: the calls of ``Line.shift`` / ``psum`` / ``all_gather``
         (parallel/mesh.py) during one ``batched_register`` on a pair mesh
         (none expected: pairs are independent) and one sharded ICP of 2
         iterations on a block mesh, 8 positions each; with fewer devices
         the devices repeat and the shards run in turn.
    """
    from tpu3dm_torch.parallel.mesh import Line, make_mesh, reset_collective_counts
    from tpu3dm_torch.parallel.register import batched_register
    from tpu3dm_torch.parallel.sharded_icp import icp_refine_sharded
    from tpu3dm_torch.registration.batch import pair_bits_shape

    dev = resolve_device(device)
    rate = _kernel_nn_rate(roofline_json)
    bytes_per_point = 25  # 3 f32 points + 3 f32 normals + 1 bool mask

    rows = []
    for nb in mesh_sizes:
        shard = n_points // nb
        t_compute = (shard * shard) / rate  # one ring step's NN block
        t_comm = (shard * bytes_per_point) / link_bytes_per_s
        eff = t_compute / (t_compute + t_comm)
        rows.append(
            {
                "mesh": nb,
                "shard_points": shard,
                "ring_step_compute_ms": round(t_compute * 1e3, 3),
                "ring_step_ppermute_ms": round(t_comm * 1e3, 4),
                "compute_comm_ratio": round(t_compute / t_comm, 1),
                "efficiency_model": round(eff, 4),
            }
        )
        logger.info(
            "model mesh=%d: compute %.2f ms vs shift %.3f ms per ring step -> efficiency %.3f",
            nb, t_compute * 1e3, t_comm * 1e3, eff,
        )

    # --- collective census ---------------------------------------------------
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    n_dev = 8
    devices = [cards[i % len(cards)] for i in range(n_dev)]
    census = {}
    rng = np.random.default_rng(0)
    P, M = n_dev, 256
    cloud = [rng.normal(size=(P, M, 3)), rng.random((P, M, 33)), np.ones((P, M), bool),
             np.zeros((P, M, 3))]
    cloud += [rng.normal(size=(P, M, 3)), rng.random((P, M, 33))] + cloud[2:4]
    arrs = [torch.as_tensor(a if a.dtype == bool else a.astype(np.float32), device=devices[0])
            for a in cloud]
    bits = draw_bits((P,) + pair_bits_shape(M, ransac_iterations=512)[0],
                     torch.Generator().manual_seed(0))
    mesh = make_mesh(n_dev, 1, devices=devices)
    reset_collective_counts()
    batched_register(mesh, *arrs, bits, dist_thresh=0.45,
                     icp_thresh=0.12, ransac_iterations=512, icp_iterations=2)
    census["pair_dp_batched_register"] = dict(Line.calls)

    blk_mesh = make_mesh(1, n_dev, devices=devices)
    nn = 64 * n_dev
    pts = rng.normal(size=(nn, 3)).astype(np.float32)
    nrm = rng.normal(size=(nn, 3)).astype(np.float32)
    reset_collective_counts()
    icp_refine_sharded(blk_mesh, pts, pts, np.eye(4, dtype=np.float32), tgt_normals=nrm,
                       dist_thresh=0.1, max_iterations=2, point_to_plane=True)
    census["sharded_icp"] = dict(Line.calls)
    reset_collective_counts()

    # JAX's keys nn_rate_entries_per_s_measured_* and *_bytes_per_s_per_link
    # (tpu3dm/apps/benchmark.py:1274-1275) name the part they were measured
    # on; the port's name the H100's measured kernel and its published link.
    report = {
        "benchmark": "scaling_model",
        "n_points": n_points,
        "nn_rate_entries_per_s_measured": rate,
        "nn_rate_source": f"{roofline_json}: nn_tiled_65536x65536_d3 (kernel 4)",
        "link_bytes_per_s_per_direction": link_bytes_per_s,
        "link_source": "published: NVIDIA H100 SXM NVLink, 900 GB/s a card in both "
                       "directions together, half each way",
        "bytes_per_point_ppermute": bytes_per_point,
        "note": (
            "Efficiency model for the spatial (ring-NN / sharded-ICP) axis "
            "from the measured kernel rate and a published link rate; the "
            "pair axis calls no collective (see census) and scales with the "
            "cards up to host overhead."
        ),
        "rows": rows,
        "collective_census": census,
        "census_devices": [str(d) for d in devices],
    }
    _write(out_json, report)
    logger.info("wrote %s", out_json)
    return report


def add_args(ap: argparse.ArgumentParser) -> None:
    """Reference CLI surface (benchmark_ransac.py:283-322)."""
    ap.add_argument("--source", default=None, help="source PLY (default: synthetic)")
    ap.add_argument("--target", default=None, help="target PLY (default: synthetic)")
    ap.add_argument("--voxel-size", type=float, default=0.3)
    ap.add_argument("--noise-ratio", type=float, default=0.0)
    ap.add_argument("--test-iterations", type=int, default=100)
    ap.add_argument("--ransac-iterations", type=int, default=4096)
    ap.add_argument("--out-txt", default=DEFAULT_TXT)
    ap.add_argument("--out-json", default=DEFAULT_JSON)
    ap.add_argument(
        "--multiway", type=int, default=0, metavar="N",
        help="run the N-cloud multiway benchmark (BASELINE config 5) "
        "instead of the phase benchmark",
    )
    ap.add_argument(
        "--track-memory", action="store_true",
        help="record per-span host RSS deltas in the profiler report "
        "(reference: optional psutil tracking, profiler.py:14-18)",
    )
    ap.add_argument(
        "--sweep", action="store_true",
        help="run the hypothesis-count x inlier-threshold grid sweep "
        "(BASELINE config 3) instead of the phase benchmark",
    )
    ap.add_argument(
        "--sweep-counts",
        type=lambda s: tuple(int(x) for x in s.split(",")),
        default=(1024, 4096, 16384, 65536),
        help="comma-separated hypothesis counts for --sweep",
    )
    ap.add_argument(
        "--large", type=int, default=None, metavar="N",
        help="run the large-cloud benchmark at N points (BASELINE config 4) "
        "instead of the phase benchmark",
    )
    ap.add_argument(
        "--scaling", action="store_true",
        help="run the mesh scaling benchmark (pairs/s at mesh sizes 1..N, "
        "at most the card count)",
    )
    ap.add_argument(
        "--mesh-sizes",
        type=lambda s: tuple(int(x) for x in s.split(",")),
        default=(1, 2, 4, 8),
        help="comma-separated mesh sizes for --scaling",
    )
    ap.add_argument("--scaling-pairs", type=int, default=64,
                    help="pairs per device for --scaling")
    ap.add_argument("--scaling-points", type=int, default=20_000,
                    help="points per cloud for --scaling")
    ap.add_argument(
        "--scaling-model", action="store_true",
        help="model-based multi-card scaling estimate (the measured kernel "
        "rate of the kernel report + the published link rate) + collective census",
    )
    ap.add_argument(
        "--fpfh-ab", action="store_true",
        help="A/B the capped (Open3D-parity max_nn) vs uncapped feature "
        "paths: RANSAC fitness + rotation error per config",
    )
    ap.add_argument(
        "--overlap-sweep", action="store_true",
        help="partial-overlap robustness sweep (trim_ply scenario) with an "
        "alias-rescue A/B per overlap fraction",
    )
    ap.add_argument(
        "--serve", type=int, default=0, metavar="N",
        help="online-serving benchmark: N single-pair requests from "
        "concurrent clients through the micro-batching engine",
    )
    ap.add_argument("--serve-clients", type=int, default=8, help="client threads for --serve")
    ap.add_argument("--serve-max-batch", type=int, default=256,
                    help="engine micro-batch cap for --serve")
    ap.add_argument(
        "--serve-distinct", type=int, default=8,
        help="distinct target models for --serve (1 = the one-model "
        "steady state, maximally exercising the resident-target path)",
    )
    ap.add_argument(
        "--serve-ab", action="store_true",
        help="also measure the other pipeline_depth for the --serve run "
        "(upload/compute overlap A/B)",
    )
    ap.add_argument(
        "--stream", type=int, default=0, metavar="N",
        help="disk->result streaming benchmark: N fresh PLY pairs through "
        "the fused ingest+register pipeline (gated fresh-pairs/s)",
    )
    ap.add_argument("--stream-window", type=int, default=128,
                    help="pairs per streaming window for --stream")
    ap.add_argument("--stream-points", type=int, default=20_000,
                    help="points per cloud for --stream")
    ap.add_argument(
        "--stream-ab", action="store_true",
        help="also measure the generic (unfused) streaming path for an A/B",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the runners run (default: the CUDA card)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap)
    args = ap.parse_args(argv)
    if getattr(args, "track_memory", False):
        Profiler.enable_memory_tracking(True)
    dev = args.device

    def out_for(name: str) -> str:
        # Don't clobber the phase benchmark's report with the default name.
        return str(RUNS / name) if args.out_json == DEFAULT_JSON else args.out_json

    if args.overlap_sweep:
        run_overlap_benchmark(voxel_size=args.voxel_size,
                              ransac_iterations=args.ransac_iterations,
                              out_json=out_for("benchmark_overlap.json"), device=dev)
        return 0
    if args.serve:
        run_serve_benchmark(
            args.serve, clients=args.serve_clients, max_batch=args.serve_max_batch,
            n_distinct=args.serve_distinct, ransac_iterations=args.ransac_iterations,
            overlap_ab=args.serve_ab, out_json=out_for("benchmark_serve.json"), device=dev,
        )
        return 0
    if args.stream:
        run_stream_benchmark(
            args.stream, n_points=args.stream_points, window=args.stream_window,
            ransac_iterations=args.ransac_iterations, generic_ab=args.stream_ab,
            out_json=out_for("benchmark_stream.json"), device=dev,
        )
        return 0
    if args.large:
        run_large_cloud_benchmark(args.large, out_json=out_for("benchmark_large.json"),
                                  device=dev)
        return 0
    if args.multiway:
        run_multiway_benchmark(args.multiway, out_json=out_for("benchmark_multiway.json"),
                               device=dev)
        return 0
    if args.scaling:
        run_scaling_benchmark(
            args.mesh_sizes, pairs_per_device=args.scaling_pairs,
            n_points=args.scaling_points, out_json=out_for("benchmark_scaling.json"),
            device=dev,
        )
        return 0
    if args.scaling_model:
        run_scaling_model(out_json=out_for("benchmark_scaling_model.json"), device=dev)
        return 0
    if args.fpfh_ab:
        run_fpfh_ab_benchmark(voxel_size=args.voxel_size,
                              out_json=out_for("benchmark_fpfh_ab.json"), device=dev)
        return 0
    if args.sweep:
        run_hypothesis_sweep(
            args.source, args.target, voxel_size=args.voxel_size,
            hypothesis_counts=args.sweep_counts, out_json=out_for("benchmark_sweep.json"),
            device=dev,
        )
        return 0
    run_comprehensive_benchmark(
        args.source, args.target, voxel_size=args.voxel_size, noise_ratio=args.noise_ratio,
        test_iterations=args.test_iterations, ransac_iterations=args.ransac_iterations,
        out_txt=args.out_txt, out_json=args.out_json, device=dev,
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
