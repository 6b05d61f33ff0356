"""tpu3dm_torch command-line interface (port of tpu3dm/apps/cli.py).

Subcommands cover every reference entry point (SURVEY.md §7.8):
  register   — src/main.py: load two PLYs, RANSAC + ICP, export views
  bench      — benchmark_ransac.py: comprehensive phase benchmark
  crashtest  — test_ransac_crash.py: robustness suite (real exit code)
  convert    — convert_stl-ply.py: STL -> PLY point cloud
  trim       — trim_ply.py: crop a cloud (headless: bounds/fraction instead
               of interactive selection)
  trace      — _visualize_matcher.py: step-by-step RANSAC with a recorded
               per-chunk trace + HTML snapshot instead of a GUI
  multiway   — N-cloud alignment + pose-graph solve (no reference analog)
and info, kernels, register-batch and serve.

Every subcommand takes JAX's options and defaults, and one more:
``--device {cuda,cpu}`` (default cuda; cpu runs the plain PyTorch
versions).  ``--seed s`` seeds the port's ``torch.Generator``s where JAX
takes ``PRNGKey(s)``.  Default output files are JAX's names under
``torch_runs/``.

    python -m tpu3dm_torch.apps.cli <subcommand> --help
    tpu3dm-torch <subcommand> ...          (installed)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpu3dm_torch.apps.benchmark import RUNS
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _cmd_register(args) -> int:
    from tpu3dm_torch import resolve_device
    from tpu3dm_torch.core.config import PipelineConfig, PreprocessConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points
    from tpu3dm_torch.registration.pipeline import register_pair
    from tpu3dm_torch.viz.export import export_registration_html, export_registration_ply

    dev = resolve_device(args.device)
    cfg = PipelineConfig.with_voxel_size(args.voxel_size)
    noise = args.noise_sigma
    if getattr(args, "reference_noise", False):
        # Reference parity run: the always-on loader noise (ply.py:59-62).
        noise = cfg.preprocess.reference_noise_sigma
    if noise > 0:
        cfg = PipelineConfig(
            preprocess=PreprocessConfig(voxel_size=args.voxel_size, noise_sigma=noise),
            ransac=cfg.ransac,
            icp=cfg.icp,
        )
    if args.source and args.target:
        from tpu3dm_torch.io.ply import read_ply

        # Reference loader's path contract (ply.py:46-51).
        for p in (args.source, args.target):
            if not Path(p).exists():
                raise FileNotFoundError(f"Ply file not found: {p}")
            if Path(p).suffix.lower() != ".ply":
                raise TypeError(f"File is not a ply file: {p}")
        s = read_ply(args.source)["points"]
        t = read_ply(args.target)["points"]
    else:
        logger.info("no files given; registering the synthetic benchmark pair")
        s, t, _ = make_benchmark_pair(1_000_000 if args.large else 20_000, seed=0, sigma=0.01)

    if args.large or (args.large is None and max(len(s), len(t)) > 200_000):
        # Large-cloud path: downsampled two-mode RANSAC + verified restarts,
        # block-sparse full-resolution ICP (registration/large.py).
        from tpu3dm_torch.registration.large import register_arrays_large

        # None keeps the large path's own default (4 verified restarts).
        fine, coarse = register_arrays_large(
            np.asarray(s), np.asarray(t), cfg, generator=_gen(args.seed),
            restarts=args.restarts if args.restarts is not None else 4, device=dev,
        )
        T = fine.transformation.cpu().numpy()
        print(json.dumps({
            "ransac": {"fitness": float(coarse.fitness),
                       "inlier_rmse": float(coarse.inlier_rmse),
                       "iterations": int(coarse.iterations)},
            "icp": {"fitness": float(fine.fitness),
                    "inlier_rmse": float(fine.inlier_rmse),
                    "iterations": int(fine.iterations)},
            "transformation": T.tolist(),
            "path": "large",
        }, indent=2))
        if args.out_ply or args.out_html:
            # Views of the voxel-downsampled clouds: a 1M+ point HTML scene
            # is unusable, and the reference viewer also draws the
            # downsampled clouds (draw_registration_result.py:33-34).
            from tpu3dm_torch.preprocess.voxel import voxel_downsample_host

            sd = voxel_downsample_host(np.asarray(s), cfg.preprocess.voxel_size, device="cpu")
            td = voxel_downsample_host(np.asarray(t), cfg.preprocess.voxel_size, device="cpu")
            if args.out_ply:
                export_registration_ply(args.out_ply, sd, td, T)
                logger.info("wrote %s", args.out_ply)
            if args.out_html:
                export_registration_html(
                    args.out_html, sd, td, T,
                    info=(f"fitness={float(fine.fitness):.3f} "
                          f"rmse={float(fine.inlier_rmse):.4f} (large path)"),
                )
                logger.info("wrote %s", args.out_html)
        return 0

    src = preprocess_points(np.asarray(s), cfg.preprocess, device=dev)
    tgt = preprocess_points(np.asarray(t), cfg.preprocess, device=dev)

    out = register_pair(
        src, tgt, cfg, generator=_gen(args.seed),
        restarts=args.restarts if args.restarts is not None else 1,
    )
    T = out.transformation.cpu().numpy()
    print(json.dumps({
        "ransac": {"fitness": float(out.ransac.fitness),
                   "inlier_rmse": float(out.ransac.inlier_rmse),
                   "iterations": int(out.ransac.iterations)},
        "icp": {"fitness": float(out.icp.fitness),
                "inlier_rmse": float(out.icp.inlier_rmse),
                "iterations": int(out.icp.iterations)},
        "transformation": T.tolist(),
    }, indent=2))
    if args.out_ply:
        export_registration_ply(args.out_ply, src.down, tgt.down, T)
        logger.info("wrote %s", args.out_ply)
    if args.out_html:
        export_registration_html(
            args.out_html, src.down, tgt.down, T,
            info=f"fitness={float(out.icp.fitness):.3f} rmse={float(out.icp.inlier_rmse):.4f}",
        )
        logger.info("wrote %s", args.out_html)
    return 0


def _cmd_convert(args) -> int:
    from tpu3dm_torch.io.ply import write_ply
    from tpu3dm_torch.io.stl import stl_to_point_cloud

    pts = stl_to_point_cloud(args.source)
    write_ply(args.dest, pts, binary=not args.ascii)
    logger.info("converted %s (%d vertices) -> %s", args.source, len(pts), args.dest)
    return 0


def _cmd_trim(args) -> int:
    from tpu3dm_torch.io.crop import crop_file

    kept = crop_file(args.source, args.dest, bounds=args.bounds, fraction=args.fraction,
                     axis=args.axis)
    logger.info("wrote %s (%d points kept)", args.dest, kept)
    return 0


def _cmd_trace(args) -> int:
    from tpu3dm_torch import resolve_device
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.synthetic import make_benchmark_pair
    from tpu3dm_torch.preprocess.pipeline import load_cloud, preprocess_points
    from tpu3dm_torch.viz.export import (
        export_iteration_trace,
        export_ransac_animation_html,
        export_registration_html,
    )
    from tpu3dm_torch.viz.trace import traced_ransac

    dev = resolve_device(args.device)
    cfg = PipelineConfig.with_voxel_size(args.voxel_size)
    if args.source and args.target:
        src = load_cloud(args.source, cfg.preprocess, device=dev)
        tgt = load_cloud(args.target, cfg.preprocess, device=dev)
    else:
        s, t, _ = make_benchmark_pair(20_000, seed=0, sigma=0.01)
        src = preprocess_points(s, cfg.preprocess, device=dev)
        tgt = preprocess_points(t, cfg.preprocess, device=dev)

    result, trace = traced_ransac(
        src.down, tgt.down, cfg.ransac, generator=_gen(args.seed),
        noise_ratio=args.noise_ratio, chunk=args.update_interval,
    )
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    export_iteration_trace(args.out, trace)
    logger.info("wrote %s (%d trace rows)", args.out, len(trace))
    info = f"traced RANSAC best fitness={float(result.fitness):.3f}"
    if args.out_html:
        export_registration_html(args.out_html, src.down, tgt.down,
                                 result.transformation.cpu().numpy(), info=info)
        logger.info("wrote %s", args.out_html)
    if args.out_anim:
        export_ransac_animation_html(args.out_anim, src.down, tgt.down, trace, info=info)
        logger.info("wrote %s (%d frames)", args.out_anim, len(trace))
    return 0


def _manifest_bits(n_pairs: int, args, cfg):
    """Each manifest pair's RANSAC bits (and extra bits with the adaptive
    budget), drawn pair after pair from a generator seeded ``--seed``: a
    pair's bits follow its position in the whole manifest, so the windowed
    and whole-manifest modes register every pair identically (JAX: one key
    a pair from ``split(PRNGKey(seed), n)``)."""
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration.batch import pair_bits_shape

    # At the default bucket quantum (256) and above, a pair's bit shapes do
    # not depend on its bucket.
    shape, extra_shape = pair_bits_shape(
        256, ransac_iterations=args.ransac_iterations, rescue_restarts=args.rescue_restarts,
        adapt_iterations=cfg.ransac.adapt_iterations)
    gen = _gen(args.seed)
    bits, extra = [], []
    for _ in range(n_pairs):
        bits.append(draw_bits(shape, gen))
        extra.append(None if extra_shape is None else draw_bits(extra_shape, gen))
    return torch.stack(bits), (None if extra_shape is None else torch.stack(extra))


def _cmd_register_batch(args) -> int:
    """Register many PLY pairs in capacity-bucketed batched calls.

    The manifest is a text file with one ``source.ply target.ply`` pair per
    line (or a JSON list of [source, target] pairs).  Results go to one JSON
    file indexed like the manifest.
    """
    from tpu3dm_torch import resolve_device
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.loader import read_ply_many
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch
    from tpu3dm_torch.registration.batch import BatchResult, register_pairs_batched

    dev = resolve_device(args.device)
    cfg = PipelineConfig.with_voxel_size(args.voxel_size)
    text = Path(args.manifest).read_text()
    if text.lstrip().startswith("["):
        pair_paths = [(a, b) for a, b in json.loads(text)]
    else:
        pair_paths = [tuple(line.split()) for line in text.splitlines() if line.strip()]
        for pp in pair_paths:
            if len(pp) != 2:
                raise ValueError(f"manifest line needs 2 paths, got: {pp}")

    store = None
    pair_names = None
    if args.checkpoint_dir:
        from tpu3dm_torch.multiway.checkpoint import CheckpointStore

        store = CheckpointStore(args.checkpoint_dir)
        # The run configuration is part of the record key: a re-run with a
        # different voxel size / seed / budget recomputes into new records.
        cfg_tag = (f"v{args.voxel_size}/s{args.seed}/r{args.ransac_iterations}"
                   f"/x{args.rescue_restarts}")
        pair_names = [f"{a}\t{b}\t{cfg_tag}" for a, b in pair_paths]
        store.write_manifest(
            kind="register-batch", n_pairs=len(pair_paths),
            voxel_size=args.voxel_size, seed=args.seed,
            ransac_iterations=args.ransac_iterations,
            rescue_restarts=args.rescue_restarts,
        )
        # Skip ingest for clouds only needed by already-completed pairs.
        pending = {
            p
            for (a, b), name in zip(pair_paths, pair_names)
            if store.get_pair(name) is None
            for p in (a, b)
        }
    else:
        pending = {p for pair in pair_paths for p in pair}

    all_bits, all_extra = _manifest_bits(len(pair_paths), args, cfg)
    knobs = dict(ransac_iterations=args.ransac_iterations,
                 rescue_restarts=args.rescue_restarts, checkpoint=store, device=dev)

    if args.window > 0:
        # Streaming mode: host memory bounded by the window; the next
        # window's file ingest overlaps this window's registration
        # (io/loader.py double buffer).
        from tpu3dm_torch.io.loader import iter_preprocessed_windows

        skip = {p for pair in pair_paths for p in pair} - pending
        out_T = np.zeros((len(pair_paths), 4, 4), np.float32)
        out_fit = np.zeros((len(pair_paths),), np.float32)
        out_rmse = np.zeros((len(pair_paths),), np.float32)
        bucket_of = [0] * len(pair_paths)
        for idxs, procs in iter_preprocessed_windows(
            pair_paths, cfg.preprocess, window=args.window,
            workers=args.io_workers, skip_paths=skip,
            # The batch path registers the DOWNSAMPLED clouds only.
            full_normals=False, device=dev,
        ):
            _dummy = next(iter(procs.values()), None)
            wpairs = [(procs.get(pair_paths[i][0], _dummy), procs.get(pair_paths[i][1], _dummy))
                      for i in idxs]
            wres = register_pairs_batched(
                wpairs, cfg, pair_names=[pair_names[i] for i in idxs] if pair_names else None,
                pair_bits=all_bits[idxs],
                pair_extra_bits=None if all_extra is None else all_extra[idxs], **knobs,
            )
            for j, i in enumerate(idxs):
                out_T[i] = wres.transforms[j]
                out_fit[i] = wres.ransac_fitness[j]
                out_rmse[i] = wres.icp_rmse[j]
                bucket_of[i] = wres.bucket_of_pair[j]
            logger.info("window %d-%d registered (%d pairs)", idxs[0], idxs[-1], len(idxs))
        res = BatchResult(out_T, out_fit, out_rmse, bucket_of)
    else:
        # One batched ingest for every distinct cloud file still needed.
        uniq = sorted(pending)
        raw = [d["points"] for d in read_ply_many(uniq, workers=args.io_workers)]
        procs = dict(zip(uniq, preprocess_points_batch(
            raw, cfg.preprocess, workers=args.io_workers,
            full_normals=False,  # the batch path registers down clouds only
            device=dev,
        )))
        # Completed pairs get a placeholder; register_pairs_batched never
        # touches the clouds of checkpoint-restored pairs.
        _dummy = next(iter(procs.values()), None)
        pairs = [(procs.get(a, _dummy), procs.get(b, _dummy)) for a, b in pair_paths]
        res = register_pairs_batched(pairs, cfg, pair_names=pair_names, pair_bits=all_bits,
                                     pair_extra_bits=all_extra, **knobs)
    payload = [
        {
            "source": a,
            "target": b,
            "transformation": np.asarray(res.transforms[i]).tolist(),
            "ransac_fitness": float(res.ransac_fitness[i]),
            "icp_rmse": float(res.icp_rmse[i]),
            "bucket_capacity": res.bucket_of_pair[i],
        }
        for i, (a, b) in enumerate(pair_paths)
    ]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(payload, indent=2))
    logger.info("wrote %s (%d pairs)", args.out, len(payload))
    return 0


def _cmd_multiway(args) -> int:
    from tpu3dm_torch import resolve_device
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.io.loader import read_ply_many
    from tpu3dm_torch.multiway.posegraph import register_multiway, register_multiway_batched
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    dev = resolve_device(args.device)
    cfg = PipelineConfig.with_voxel_size(args.voxel_size)
    raw = [d["points"] for d in read_ply_many(args.files)]
    # The batched path registers down clouds only; the sequential path
    # refines with full-resolution ICP and needs the full-resolution normals.
    clouds = preprocess_points_batch(raw, cfg.preprocess, full_normals=not args.batched,
                                     device=dev)
    register = register_multiway_batched if args.batched else register_multiway
    out = register(clouds, cfg, generator=_gen(args.seed), checkpoint_dir=args.checkpoint_dir,
                   robust_delta=args.robust_delta, device=dev)
    payload = {
        "poses": np.asarray(out.poses).tolist(),
        "edges": np.asarray(out.edges).tolist(),
        "edge_fitness": np.asarray(out.edge_fitness).tolist(),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(payload, indent=2))
    logger.info("wrote %s (%d poses)", args.out, len(out.poses))
    return 0


def _cmd_info(args) -> int:
    """Runtime report: torch, CUDA devices, precision, the host C++ tier."""
    import time

    from tpu3dm_torch import csrc

    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    try:
        csrc.host_library()
        host = "loaded"
    except (RuntimeError, OSError) as e:
        host = f"unavailable ({str(e).splitlines()[0]})"
    payload = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": args.device,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "device_count": count,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "host_tier": host,
    }
    if args.probe and host == "loaded":
        from tpu3dm_torch.preprocess.voxel import voxel_means

        pts = np.random.default_rng(0).uniform(-1, 1, (100_000, 3))
        t0 = time.perf_counter()
        out = voxel_means(pts, 0.05)
        payload["host_voxel_100k_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        payload["host_voxel_100k_voxels"] = int(out.shape[0])
    if args.probe:
        from tpu3dm_torch import resolve_device

        dev = resolve_device(args.device)
        t0 = time.perf_counter()
        (torch.ones(8, device=dev) * 2.0).cpu()  # the first launch, context set-up included
        payload["first_dispatch_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(payload, indent=2))
    return 0


def _cmd_kernels(args) -> int:
    from tpu3dm_torch.apps.kernelbench import run_kernel_benchmark

    run_kernel_benchmark(quick=args.quick, out_path=args.out, device=args.device)
    return 0


def _cmd_serve(args) -> int:
    """Run the request-batching registration server (serve/server.py)."""
    from tpu3dm_torch.core.config import PipelineConfig
    from tpu3dm_torch.serve import RegistrationServer, ServeConfig

    server = RegistrationServer(
        args.host,
        args.port,
        pipeline=PipelineConfig.with_voxel_size(args.voxel_size),
        serve=ServeConfig(
            max_batch=args.max_batch,
            max_delay_ms=args.max_delay_ms,
            ransac_iterations=args.ransac_iterations,
            icp_iterations=args.icp_iterations,
            rescue_restarts=args.rescue_restarts,
            max_pending=args.max_pending,
        ),
        cache_size=args.cache_size,
        path_root=args.path_root,
        device=args.device,
    )
    prewarm_s = None
    if args.prewarm:
        # Warm the steady-state shapes BEFORE announcing the port; batch size
        # 1 beside max_batch, since a lone first request forms a micro-batch
        # of 1.
        prewarm_s = server.prewarm(
            caps=args.prewarm_caps or None,
            batch_sizes=sorted({1, args.max_batch}) if args.max_batch else None,
        )
    print(json.dumps({
        "listening": f"{server.host}:{server.port}",
        **({"prewarm_s": round(prewarm_s, 1)} if prewarm_s is not None else {}),
    }))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
        server.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpu3dm-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    # The one option JAX lacks, on every subcommand.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: the CUDA card; cpu runs the plain "
                             "PyTorch versions)")

    def parser(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    p = parser("info", help="runtime report: torch, CUDA devices, host C++ tier")
    p.add_argument("--probe", action="store_true",
                   help="also time a host voxel hash and the first device launch")
    p.set_defaults(fn=_cmd_info)

    p = parser("register", help="register two point clouds (main.py parity)")
    p.add_argument("source", nargs="?", default=None)
    p.add_argument("target", nargs="?", default=None)
    p.add_argument("--voxel-size", type=float, default=0.3)
    p.add_argument("--noise-sigma", type=float, default=0.0,
                   help="loader Gaussian noise (reference always-on value: 0.05)")
    p.add_argument("--reference-noise", action="store_true",
                   help="parity run: inject the reference's always-on loader "
                        "noise (PreprocessConfig.reference_noise_sigma=0.05, "
                        "ply.py:59-62)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-ply", default=None)
    p.add_argument("--out-html", default=None)
    p.add_argument("--large", action="store_true", default=None,
                   help="force the large-cloud path (block-sparse NN ICP); "
                        "auto-selected above 200k points")
    p.add_argument("--restarts", type=int, default=None,
                   help="ICP-verified RANSAC restarts (>1 rescues "
                        "near-symmetric clouds whose inlier counts tie); "
                        "default: 1 standard path, 4 large path")
    p.set_defaults(fn=_cmd_register)

    # bench's parser is the benchmark module's own (with its --device).
    p = sub.add_parser("bench", help="comprehensive benchmark (benchmark_ransac.py parity)")
    from tpu3dm_torch.apps.benchmark import add_args as bench_args, main as bench_main

    bench_args(p)
    p.set_defaults(fn=lambda a: bench_main(_reargs(a)))

    p = parser("crashtest", help="robustness suite (test_ransac_crash.py parity)")
    from tpu3dm_torch.apps.crashtest import main as crash_main

    p.set_defaults(fn=lambda a: crash_main(["--device", a.device]))

    p = parser("kernels", help="kernel roofline microbenchmarks (speed-of-light %%)")
    p.add_argument("--quick", action="store_true", help="small shapes only")
    p.add_argument("--out", default=str(RUNS / "kernel_roofline.json"))
    p.set_defaults(fn=_cmd_kernels)

    p = parser("convert", help="STL -> PLY (convert_stl-ply.py parity)")
    p.add_argument("source")
    p.add_argument("dest")
    p.add_argument("--ascii", action="store_true", help="write ASCII PLY (reference default)")
    p.set_defaults(fn=_cmd_convert)

    p = parser("trim", help="crop a cloud (trim_ply.py headless parity)")
    p.add_argument("source")
    p.add_argument("dest")
    p.add_argument("--bounds", type=float, nargs=6, default=None,
                   metavar=("XMIN", "XMAX", "YMIN", "YMAX", "ZMIN", "ZMAX"))
    p.add_argument("--fraction", type=float, default=None,
                   help="keep the lower fraction along --axis")
    p.add_argument("--axis", type=int, default=0)
    p.set_defaults(fn=_cmd_trim)

    p = parser("trace", help="step-by-step RANSAC trace (visualize_matcher parity)")
    p.add_argument("source", nargs="?", default=None)
    p.add_argument("target", nargs="?", default=None)
    p.add_argument("--voxel-size", type=float, default=0.3)
    p.add_argument("--noise-ratio", type=float, default=2.0,
                   help="bogus-correspondence ratio (reference default 2.0)")
    p.add_argument("--update-interval", type=int, default=256,
                   help="hypotheses per trace row")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=str(RUNS / "ransac_trace.jsonl"))
    p.add_argument("--out-html", default=None)
    p.add_argument("--out-anim", default=None,
                   help="animated HTML replay of the search (the headless "
                        "analog of the GUI's live iteration animation)")
    p.set_defaults(fn=_cmd_trace)

    p = parser("register-batch",
               help="register many PLY pairs (capacity-bucketed batched calls)")
    p.add_argument("manifest",
                   help="text file: one 'src.ply tgt.ply' per line, or JSON [[src,tgt],...]")
    p.add_argument("--voxel-size", type=float, default=0.3)
    p.add_argument("--ransac-iterations", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=str(RUNS / "batch_results.json"))
    p.add_argument("--checkpoint-dir", default=None,
                   help="resumable run: per-pair results are persisted here "
                        "(keyed by the pair's paths) and skipped on re-run")
    p.add_argument("--window", type=int, default=0,
                   help=">0: stream the manifest in windows of this many "
                        "pairs — host memory stays bounded and the next "
                        "window's file ingest overlaps this window's "
                        "registration; 0 ingests the whole manifest at once")
    p.add_argument("--io-workers", type=int, default=None,
                   help="threads for file parse + voxel hash (the host C++ "
                        "releases the GIL); default min(8, cpus)")
    p.add_argument("--rescue-restarts", type=int, default=0,
                   help=">0 enables the batched alias rescue inside each "
                        "fused step (two-mode RANSAC x restarts + on-device "
                        "ICP verification)")
    p.set_defaults(fn=_cmd_register_batch)

    p = parser("serve",
               help="registration server: JSON-lines TCP front of the micro-batching engine")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8421)
    p.add_argument("--voxel-size", type=float, default=0.3)
    p.add_argument("--max-batch", type=int, default=256,
                   help="max pairs coalesced into one fused step")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="linger after the first request of a batch")
    p.add_argument("--ransac-iterations", type=int, default=4096)
    p.add_argument("--icp-iterations", type=int, default=8)
    p.add_argument("--rescue-restarts", type=int, default=0,
                   help=">0 enables the batched alias rescue per request")
    p.add_argument("--cache-size", type=int, default=64,
                   help="LRU capacity of the preprocessed-cloud path cache")
    p.add_argument("--max-pending", type=int, default=1024,
                   help="in-flight request bound; excess submits are shed "
                        "with an 'overloaded' response (0 = unbounded)")
    p.add_argument("--path-root", default=None,
                   help="restrict {'path': ...} cloud specs to files under "
                        "this directory (recommended for non-loopback binds)")
    p.add_argument("--prewarm", action="store_true",
                   help="run the steady-state bucket shapes before accepting "
                        "connections (no first-request stall)")
    p.add_argument("--prewarm-caps", type=int, nargs="*", default=None,
                   help="capacity buckets to prewarm (e.g. 768 896); "
                        "default: the bucket quantum")
    p.set_defaults(fn=_cmd_serve)

    p = parser("multiway", help="N-cloud alignment + pose graph")
    p.add_argument("--robust-delta", type=float, default=None,
                   help="Geman-McClure robust pose-graph loss scale "
                        "(SE(3)-tangent residual norm, ~0.1); default pure "
                        "least squares")
    p.add_argument("files", nargs="+")
    p.add_argument("--voxel-size", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=str(RUNS / "multiway_poses.json"))
    p.add_argument("--checkpoint-dir", default=None,
                   help="resumable run: completed edges are persisted here and "
                        "skipped on re-run")
    p.add_argument("--batched", action="store_true",
                   help="register ALL edges through fused steps of up to 128 "
                        "edges (register_multiway_batched) instead of one pair "
                        "at a time")
    p.set_defaults(fn=_cmd_multiway)

    return ap


def _reargs(a) -> list[str]:
    """Re-serialize bench args for the benchmark module's own parser."""
    out = []
    for k in ("source", "target"):
        v = getattr(a, k)
        if v:
            out += [f"--{k}", v]
    for k in ("voxel_size", "noise_ratio", "test_iterations", "ransac_iterations"):
        out += [f"--{k.replace('_', '-')}", str(getattr(a, k))]
    out += ["--out-txt", a.out_txt, "--out-json", a.out_json]
    if getattr(a, "sweep", False):
        out.append("--sweep")
        out += ["--sweep-counts", ",".join(str(c) for c in a.sweep_counts)]
    if getattr(a, "large", None):
        out += ["--large", str(a.large)]
    if getattr(a, "scaling", False):
        out.append("--scaling")
        out += ["--mesh-sizes", ",".join(str(n) for n in a.mesh_sizes)]
        out += ["--scaling-pairs", str(a.scaling_pairs)]
        out += ["--scaling-points", str(a.scaling_points)]
    if getattr(a, "multiway", 0):
        out += ["--multiway", str(a.multiway)]
    if getattr(a, "scaling_model", False):
        out.append("--scaling-model")
    if getattr(a, "fpfh_ab", False):
        out.append("--fpfh-ab")
    if getattr(a, "track_memory", False):
        out.append("--track-memory")
    if getattr(a, "overlap_sweep", False):
        out.append("--overlap-sweep")
    if getattr(a, "serve", 0):
        out += ["--serve", str(a.serve)]
        out += ["--serve-clients", str(a.serve_clients)]
        out += ["--serve-max-batch", str(a.serve_max_batch)]
        out += ["--serve-distinct", str(a.serve_distinct)]
        if getattr(a, "serve_ab", False):
            out.append("--serve-ab")
    if getattr(a, "stream", 0):
        out += ["--stream", str(a.stream)]
        out += ["--stream-window", str(a.stream_window)]
        out += ["--stream-points", str(a.stream_points)]
        if getattr(a, "stream_ab", False):
            out.append("--stream-ab")
    out += ["--device", a.device]
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
