"""Disk-to-result streaming registration (port of tpu3dm/registration/stream.py),
the production ingest + register path.

  manifest of pair paths
    -> windowed threaded ingest (io/loader.py: PLY parse and host voxel grid
       on host threads; window i + 1 ingests while window i registers)
    -> the generic path: ``iter_preprocessed_windows`` (batched kNN
       features, ``full_normals=False``) and ``launch_pairs_batched`` per
       window;
    -> or the fused path (``fuse_device=True``): the host producer uploads
       the downsampled points only, the window's 2W clouds get their dense
       features in one batched call (``preprocess/dense.py``), and one
       ``fused_register_step`` registers the window's pairs at capacity
       ``down_cap``; pairs whose RANSAC fitness stays under
       ``retry_below_fitness`` are re-ingested and escalated
       (``_symmetry_probe_retry``).

Randomness.  JAX gives pair i of the manifest the key ``split(key, P)[i]``,
so the window size changes throughput, never a result.  Here pair i takes
``pair_bits[i]`` (``fused_register_step``'s bits for one lane,
``batch.pair_bits_shape``), or the i-th draw of ``generator`` in manifest
order; the retry's j-th pair (in manifest order among the retried)
``retry_bits[j]`` / ``retry_extra_bits[j]`` or the j-th draw of
``retry_generator``.  Unlike JAX, no window and no retry is padded to a
compiled shape: eager PyTorch compiles nothing, and lanes are independent,
so the real pairs' results are the same.

The fused step synchronises with the host inside, so a window's launch
returns when its work is all but done, and only the producer's host ingest
of the next window overlaps device work.  JAX resolves each window one
window behind to overlap its asynchronous dispatch; here that would only
stamp each window's resolution after the next window's work and skew the
steady rate, so each window resolves as soon as it is launched.  Window 1
pays the kernels' first builds and CUDA's initialisation (JAX: its
compiles), which is why the steady rate counts windows 2..N.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.io.loader import (
    iter_preprocessed_windows,
    pair_windows,
    prefetched,
    read_ply_many,
    thread_device,
    voxel_downsample_many,
)
from tpu3dm_torch.parallel.multipair import draw_bits, extra_chunk_count
from tpu3dm_torch.preprocess.dense import down_features_dense
from tpu3dm_torch.preprocess.pipeline import down_features
from tpu3dm_torch.registration.batch import launch_pairs_batched, pair_bits_shape
from tpu3dm_torch.registration.fused import escalated_register_step, fused_register_step

# The symmetry-probe retry's budget (JAX's stream.py:_symmetry_probe_retry).
RETRY_MODES = 8
RETRY_ITERATIONS = 4096
RETRY_ADAPT_ITERATIONS = 16384


@dataclasses.dataclass
class StreamResult:
    """Per-pair outputs + pipeline timing of a streamed manifest run."""

    transforms: np.ndarray  # [P, 4, 4]
    ransac_fitness: np.ndarray  # [P]
    icp_rmse: np.ndarray  # [P]
    bucket_of_pair: list[int]
    window_pairs: list[int]  # pairs per window
    window_done_s: list[float]  # wall clock at each window's resolution
    total_seconds: float  # manifest start -> last resolve (+ the retry)
    fresh_pairs_per_sec: float  # whole manifest / total (first builds included)
    steady_pairs_per_sec: float | None  # windows 2..N (+ the retry's warm time)
    ingest_seconds: list[float] = dataclasses.field(default_factory=list)
    # host-side parse + voxel + pack wall time per window (fused path only)
    retry_pairs: list[int] = dataclasses.field(default_factory=list)
    # manifest indices escalated through the symmetry-probe retry
    retry_seconds: float = 0.0


def _rows(x, idxs: list[int]):
    """Rows ``idxs`` of a [P, ...] tensor or of a sequence of P tensors."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x[idxs]
    return torch.stack([torch.as_tensor(x[i]) for i in idxs])


def _checked_rows(name: str, given, need: int) -> None:
    if given is not None and len(given) < need:
        raise ValueError(f"{name} has {len(given)} rows for {need} pairs")


def _drawn(shapes, n: int, generator: torch.Generator) -> list[torch.Tensor]:
    """n pairs' bits of each shape in ``shapes``, [n, *shape] each, drawn
    pair after pair."""
    rows = [[draw_bits(shape, generator) for shape in shapes] for _ in range(n)]
    return [torch.stack(col) for col in zip(*rows)]


def _iter_host_windows(
    pair_paths: list[tuple[str, str]],
    voxel_size: float,
    *,
    window: int,
    workers: int | None,
    down_cap: int,
):
    """Host-only windowed producer for the fused device path.

    Yields ``(idxs, pts [2W, cap, 3] float32, masks [2W, cap] bool,
    ingest_seconds)`` with sources in rows [0, W) and targets in [W, 2W).
    Parse and voxel grid run on a prefetch thread, one window ahead, with
    no device work, so the consumer owns the device.
    """
    def ingest(idxs):
        t0 = time.monotonic()
        uniq = sorted({p for i in idxs for p in pair_paths[i]})
        raws = [d["points"] for d in read_ply_many(uniq, workers=workers)]
        downs = voxel_downsample_many(raws, voxel_size, workers=workers, device="cpu")
        tight = {p: d.points[d.mask].numpy() for p, d in zip(uniq, downs)}
        w = len(idxs)
        pts = np.zeros((2 * w, down_cap, 3), np.float32)
        masks = np.zeros((2 * w, down_cap), bool)
        for j, i in enumerate(idxs):
            for slot, path in ((j, pair_paths[i][0]), (w + j, pair_paths[i][1])):
                t = tight[path]
                n = t.shape[0]
                if n > down_cap:
                    raise ValueError(
                        f"{path}: {n} downsampled points exceed down_cap={down_cap}")
                pts[slot, :n] = t
                masks[slot, :n] = True
        return idxs, pts, masks, time.monotonic() - t0

    return prefetched(pair_windows(len(pair_paths), window), ingest)


def _featured(pts: torch.Tensor, masks: torch.Tensor, config: PipelineConfig,
              dense_features: bool) -> tuple[PointCloud, PointCloud]:
    """(sources, targets) of a window's [2W, cap] clouds with their normals
    and FPFH features, the dense or the shared-kNN formulation."""
    pp = config.preprocess
    clouds = PointCloud(points=pts, mask=masks, normals=torch.zeros_like(pts),
                        features=torch.zeros(pts.shape[:2] + (0,), device=pts.device))
    features = down_features_dense if dense_features else down_features
    featured = features(clouds, pp.normal_radius, pp.fpfh_radius,
                        normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn)
    w = pts.shape[0] // 2
    half = [PointCloud(*(getattr(featured, f)[sl] for f in
                         ("points", "mask", "normals", "features")))
            for sl in (slice(0, w), slice(w, 2 * w))]
    return half[0], half[1]


@dataclasses.dataclass(frozen=True)
class _FusedWindow:
    """Features + one ``fused_register_step`` over a window's pairs (JAX's
    ``_fused_ingest_register`` program)."""

    config: PipelineConfig
    ransac_iterations: int
    icp_iterations: int
    icp_solves_per_nn: int
    approx_score: bool
    rescue_restarts: int
    rescue_modes: int
    sample_mode: str
    dense_features: bool

    def bits_shape(self, down_cap: int) -> tuple:
        return pair_bits_shape(down_cap, ransac_iterations=self.ransac_iterations,
                               rescue_restarts=self.rescue_restarts,
                               sample_mode=self.sample_mode)[0]

    def __call__(self, pts, masks, bits, dev):
        src, tgt = _featured(pts, masks, self.config, self.dense_features)
        rs = self.config.ransac
        return fused_register_step(
            src.points, src.features, src.mask, None,
            tgt.points, tgt.features, tgt.mask, tgt.normals, bits, device=dev,
            dist_thresh=rs.dist_thresh,
            icp_thresh=self.config.icp.dist_thresh,
            ransac_iterations=self.ransac_iterations,
            ransac_batch=min(self.ransac_iterations, 4096),
            icp_iterations=self.icp_iterations,
            icp_solves_per_nn=self.icp_solves_per_nn,
            approx_score=self.approx_score,
            rescue_restarts=self.rescue_restarts,
            rescue_modes=self.rescue_modes,
            score_subset=rs.score_subset,
            rescore_top=rs.rescore_top,
            sample_mode=self.sample_mode,
        )


def _steady(window_pairs: list[int], window_done_s: list[float], extra_s: float = 0.0):
    """Pairs/s over windows 2..N (window 1 pays first builds), the retry's
    warm seconds counted; None with fewer than two windows."""
    if len(window_done_s) < 2:
        return None
    steady_time = window_done_s[-1] - window_done_s[0] + extra_s
    return sum(window_pairs[1:]) / steady_time if steady_time > 0 else None


def stream_register_pairs(
    pair_paths: list[tuple[str, str]],
    config: PipelineConfig | None = None,
    *,
    window: int,
    workers: int | None = None,
    generator: torch.Generator | None = None,
    pair_bits=None,
    pair_extra_bits=None,
    down_cap: int | None = None,
    bucket_multiple: int = 256,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 2,
    approx_score: bool = True,
    rescue_restarts: int | None = None,
    sample_mode: str = "roll",
    fuse_device: bool = False,
    dense_features: bool = True,
    retry_below_fitness: float = 0.15,
    retry_measure_warm: bool = False,
    retry_bits=None,
    retry_extra_bits=None,
    retry_generator: torch.Generator | None = None,
    device=None,
) -> StreamResult:
    """Register a manifest of PLY pairs, streaming disk -> device -> result.

    Args:
      pair_paths: (source_path, target_path) per pair.
      window: pairs per streaming window; host memory holds one window and
        one prefetched window.
      generator / pair_bits / pair_extra_bits: each pair's RANSAC bits in
        ``fused_register_step``'s layout for one lane (see the module
        docstring); a generator seeded 0 when all are None.
      down_cap: the downsampled capacity of every cloud; required by the
        fused path (a cloud with more points raises), a floor of the
        capacity on the generic one.
      bucket_multiple / ransac_iterations / ...: registration work knobs,
        as ``register_pairs_batched`` (the fused path ignores
        ``bucket_multiple``: every pair runs at ``down_cap``).
      fuse_device: ingest only the downsampled points on the host, then
        features and registration of a window on the device in one call
        each; results are equivalent to the generic path's, not equal.
      dense_features: the fused path's features: ``down_features_dense``,
        else the shared-kNN ``down_features``.
      retry_below_fitness: the fused path escalates every pair under this
        RANSAC fitness (0 disables); ``retry_measure_warm`` times a second
        run of the escalation for the steady rate (the benchmark setting),
        else its first run counts.  retry_bits / retry_extra_bits /
        retry_generator: the escalation's bits, ``[n, 1, down_cap]`` and
        ``[n, 3, down_cap]`` for the n retried pairs in manifest order (a
        generator seeded 0xE5CA when all are None).
      device: None means CUDA and raises without it; "cpu" runs the plain
        PyTorch versions.

    Returns:
      StreamResult in manifest order with steady-state timing.
    """
    if config is None:
        config = PipelineConfig.with_voxel_size(0.3)
    if window <= 0:
        raise ValueError("window must be positive")
    dev = thread_device(device)
    n_pairs = len(pair_paths)
    _checked_rows("pair_bits", pair_bits, n_pairs)
    _checked_rows("pair_extra_bits", pair_extra_bits, n_pairs)
    if pair_bits is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    if fuse_device:
        if down_cap is None:
            raise ValueError("fuse_device requires down_cap")
        step = _FusedWindow(
            config, ransac_iterations, icp_iterations, icp_solves_per_nn, approx_score,
            config.ransac.rescue_restarts if rescue_restarts is None else rescue_restarts,
            rescue_modes=6, sample_mode=sample_mode, dense_features=dense_features)
        return _stream_fused(
            pair_paths, config, step, window=window, workers=workers, down_cap=down_cap,
            pair_bits=pair_bits, generator=generator,
            retry_below_fitness=retry_below_fitness, retry_measure_warm=retry_measure_warm,
            retry_bits=retry_bits, retry_extra_bits=retry_extra_bits,
            retry_generator=retry_generator, dev=dev)

    out_T = np.zeros((n_pairs, 4, 4), np.float32)
    out_fit = np.zeros((n_pairs,), np.float32)
    out_rmse = np.zeros((n_pairs,), np.float32)
    bucket_of = [0] * n_pairs
    window_pairs: list[int] = []
    window_done_s: list[float] = []
    reg_kw = dict(
        bucket_multiple=bucket_multiple,
        ransac_iterations=ransac_iterations,
        icp_iterations=icp_iterations,
        icp_solves_per_nn=icp_solves_per_nn,
        approx_score=approx_score,
        rescue_restarts=rescue_restarts,
        sample_mode=sample_mode,
        device=dev,
    )

    t0 = time.monotonic()

    def resolve(idxs, pending) -> None:
        res = pending.resolve()
        for j, i in enumerate(idxs):
            out_T[i] = res.transforms[j]
            out_fit[i] = res.ransac_fitness[j]
            out_rmse[i] = res.icp_rmse[j]
            bucket_of[i] = res.bucket_of_pair[j]
        window_pairs.append(len(idxs))
        window_done_s.append(time.monotonic() - t0)

    for idxs, procs in iter_preprocessed_windows(
        pair_paths, config.preprocess, window=window, workers=workers,
        full_normals=False, down_cap=down_cap, device=dev,
    ):
        pairs = [(procs[pair_paths[i][0]], procs[pair_paths[i][1]]) for i in idxs]
        resolve(idxs, launch_pairs_batched(
            pairs, config, generator=generator, pair_bits=_rows(pair_bits, idxs),
            pair_extra_bits=_rows(pair_extra_bits, idxs), **reg_kw))

    total = window_done_s[-1] if window_done_s else 0.0
    return StreamResult(
        transforms=out_T,
        ransac_fitness=out_fit,
        icp_rmse=out_rmse,
        bucket_of_pair=bucket_of,
        window_pairs=window_pairs,
        window_done_s=window_done_s,
        total_seconds=total,
        fresh_pairs_per_sec=(n_pairs / total) if total else 0.0,
        steady_pairs_per_sec=_steady(window_pairs, window_done_s),
    )


def _symmetry_probe_retry(
    bad: list[int],
    pair_paths,
    config: PipelineConfig,
    out_T: np.ndarray,
    out_fit: np.ndarray,
    out_rmse: np.ndarray,
    *,
    down_cap: int,
    workers: int | None,
    bits: torch.Tensor,
    extra_bits: torch.Tensor,
    dev: torch.device,
    measure_warm: bool = False,
) -> float:
    """Re-ingest the ``bad`` pairs and re-register them in one call of dense
    features + ``escalated_register_step`` (8-mode RANSAC, 4096 + up to
    12288 hypotheses, alias-lattice probes, annealed fine-count election),
    each started from its current pose, which competes as a probe, so a
    result only improves under the fine count.  ``bits`` [n, 1, down_cap],
    ``extra_bits`` [n, 3, down_cap].  Returns the seconds to count against
    the steady rate: with ``measure_warm`` a second timed run (the benchmark
    setting), else the first run's."""
    rs = config.ransac
    sub_paths = [pair_paths[i] for i in bad]
    warm_s = 0.0
    for idxs, pts, masks, _ in _iter_host_windows(
        sub_paths, config.preprocess.voxel_size, window=len(sub_paths), workers=workers,
        down_cap=down_cap,
    ):
        pts_d = torch.from_numpy(pts).to(dev)
        masks_d = torch.from_numpy(masks).to(dev)
        init_T = torch.from_numpy(out_T[[bad[j] for j in idxs]])

        def run():
            src, tgt = _featured(pts_d, masks_d, config, True)
            out = escalated_register_step(
                src.points, src.features, src.mask, tgt.points, tgt.features, tgt.mask,
                tgt.normals, bits[idxs], init_T, extra_bits=extra_bits[idxs], device=dev,
                dist_thresh=rs.dist_thresh, icp_thresh=config.icp.dist_thresh,
                ransac_iterations=RETRY_ITERATIONS, ransac_batch=RETRY_ITERATIONS,
                n_modes=RETRY_MODES, adapt_iterations=RETRY_ADAPT_ITERATIONS,
            )
            return [x.cpu().numpy() for x in out]

        t_d = time.monotonic()
        T, fit, rmse = run()
        first_s = time.monotonic() - t_d
        if measure_warm:
            # Benchmark only: a second timed run, so the steady rate excludes
            # the first call's one-time costs (window-1 semantics).
            t_w = time.monotonic()
            run()
            warm_s += time.monotonic() - t_w
        else:
            warm_s += first_s
        for j, i in enumerate(idxs):
            out_T[bad[i]], out_fit[bad[i]], out_rmse[bad[i]] = T[j], fit[j], rmse[j]
    return warm_s


def _stream_fused(
    pair_paths: list[tuple[str, str]],
    config: PipelineConfig,
    step: _FusedWindow,
    *,
    window: int,
    workers: int | None,
    down_cap: int,
    pair_bits,
    generator,
    retry_below_fitness: float,
    retry_measure_warm: bool,
    retry_bits,
    retry_extra_bits,
    retry_generator,
    dev: torch.device,
) -> StreamResult:
    """The fused streaming consumer (see ``_FusedWindow``)."""
    n_pairs = len(pair_paths)
    out_T = np.zeros((n_pairs, 4, 4), np.float32)
    out_fit = np.zeros((n_pairs,), np.float32)
    out_rmse = np.zeros((n_pairs,), np.float32)
    window_pairs: list[int] = []
    window_done_s: list[float] = []
    shape = step.bits_shape(down_cap)

    t0 = time.monotonic()

    def resolve(idxs, out) -> None:
        T, fit, rmse = (x.cpu().numpy() for x in out)
        for j, i in enumerate(idxs):
            out_T[i], out_fit[i], out_rmse[i] = T[j], fit[j], rmse[j]
        window_pairs.append(len(idxs))
        window_done_s.append(time.monotonic() - t0)

    ingest_seconds: list[float] = []
    for idxs, pts, masks, ingest_s in _iter_host_windows(
        pair_paths, config.preprocess.voxel_size, window=window, workers=workers,
        down_cap=down_cap,
    ):
        ingest_seconds.append(ingest_s)
        bits = (_rows(pair_bits, idxs) if pair_bits is not None
                else _drawn([shape], len(idxs), generator)[0])
        resolve(idxs, step(torch.from_numpy(pts).to(dev), torch.from_numpy(masks).to(dev),
                           bits, dev))

    # --- hard-pair escalation: the symmetry-probe retry -----------------------
    # Quasi-symmetric geometry under degraded features can leave the true
    # pose with less correspondence support than its symmetry aliases.  The
    # alias is a symmetry conjugate of the truth, so rotations about the
    # target's principal axes composed with the elected pose land a probe in
    # the truth's basin, and the annealed fine-count election decides.  Only
    # low-fitness pairs pay.
    retry_seconds = 0.0
    retry_warm_s = 0.0
    retried: list[int] = []
    if retry_below_fitness > 0:
        bad = [i for i in range(n_pairs) if out_fit[i] < retry_below_fitness]
        if bad:
            t_r = time.monotonic()
            r_bits, r_extra = _retry_bits(len(bad), down_cap, retry_bits, retry_extra_bits,
                                          retry_generator)
            retry_warm_s = _symmetry_probe_retry(
                bad, pair_paths, config, out_T, out_fit, out_rmse, down_cap=down_cap,
                workers=workers, bits=r_bits, extra_bits=r_extra, dev=dev,
                measure_warm=retry_measure_warm,
            )
            retry_seconds = time.monotonic() - t_r
            retried = bad

    total = (window_done_s[-1] if window_done_s else 0.0) + retry_seconds
    return StreamResult(
        transforms=out_T,
        ransac_fitness=out_fit,
        icp_rmse=out_rmse,
        bucket_of_pair=[down_cap] * n_pairs,
        window_pairs=window_pairs,
        window_done_s=window_done_s,
        total_seconds=total,
        fresh_pairs_per_sec=(n_pairs / total) if total else 0.0,
        # The retry's warm run counts against the steady rate (real work of
        # the manifest); its first-call costs are excluded as window 1's are.
        steady_pairs_per_sec=_steady(window_pairs, window_done_s, retry_warm_s),
        ingest_seconds=ingest_seconds,
        retry_pairs=retried,
        retry_seconds=retry_seconds,
    )


def _retry_bits(n: int, down_cap: int, bits, extra_bits, generator):
    """The retry's (bits [n, 1, down_cap], extra_bits [n, 3, down_cap]): the
    caller's first n rows, or drawn pair after pair."""
    shape = (1, down_cap)  # one chunk: the retry's ransac_batch is its iterations
    extra_shape = (extra_chunk_count(RETRY_ITERATIONS, RETRY_ADAPT_ITERATIONS,
                                     RETRY_ITERATIONS), down_cap)
    if bits is None:
        if extra_bits is not None:
            raise ValueError("retry_extra_bits needs retry_bits")
        if generator is None:
            generator = torch.Generator().manual_seed(0xE5CA)
        return _drawn([shape, extra_shape], n, generator)
    if extra_bits is None:
        raise ValueError("the retry's adaptive budget needs retry_extra_bits beside retry_bits")
    _checked_rows("retry_bits", bits, n)
    _checked_rows("retry_extra_bits", extra_bits, n)
    return _rows(bits, list(range(n))), _rows(extra_bits, list(range(n)))


def make_stream_manifest(
    out_dir,
    n_pairs: int,
    *,
    n_points: int = 20_000,
    sigma: float = 0.01,
    seed0: int = 0,
    family: str = "arch",
) -> tuple[list[tuple[str, str]], list[np.ndarray], list[tuple[np.ndarray, np.ndarray]]]:
    """Write a synthetic fresh-cloud manifest to disk for stream benchmarks.

    ``family="mix"`` cycles arch / plate / scan pair after pair.  Returns
    (pair_paths, true_transforms, source_moments) where source_moments[i] =
    (mu [3], M2 [3, 3]) of the source cloud: the closed-form per-pair
    alignment-RMSE inputs, so gating needs no second read of the files.
    """
    from tpu3dm_torch.io.ply import write_ply
    from tpu3dm_torch.io.synthetic import make_benchmark_pair

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pair_paths: list[tuple[str, str]] = []
    trues: list[np.ndarray] = []
    moments: list[tuple[np.ndarray, np.ndarray]] = []
    for i in range(n_pairs):
        fam = ("arch", "plate", "scan")[i % 3] if family == "mix" else family
        s, t, T = make_benchmark_pair(n_points, seed=seed0 + i, sigma=sigma, family=fam)
        sp = out_dir / f"src_{seed0 + i:05d}.ply"
        tp = out_dir / f"tgt_{seed0 + i:05d}.ply"
        write_ply(sp, s.astype(np.float32))
        write_ply(tp, t.astype(np.float32))
        pair_paths.append((str(sp), str(tp)))
        trues.append(T)
        moments.append((s.mean(axis=0), s.T @ s / s.shape[0]))
    return pair_paths, trues, moments


def stream_quality(
    result: StreamResult,
    trues: list[np.ndarray],
    moments: list[tuple[np.ndarray, np.ndarray]],
) -> dict:
    """Worst-pair quality gate over a streamed run (closed-form RMSE).

    At most max(1, round(0.005 P)) pairs may sit at or over 2 deg (the
    hard-pair budget: quasi-symmetric pairs that no practical RANSAC budget
    solves); every recovered pair must sit under RMSE 0.1, and at least one
    pair must be recovered.
    """
    T_all = np.asarray(result.transforms)
    T_true = np.stack(trues)
    M = T_all[:, :3, :3] @ np.swapaxes(T_true[:, :3, :3], 1, 2)
    tr = np.clip((np.trace(M, axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_errs = np.degrees(np.arccos(tr))
    mus = np.stack([m[0] for m in moments])
    M2s = np.stack([m[1] for m in moments])
    A = T_all[:, :3, :3] - T_true[:, :3, :3]
    b = T_all[:, :3, 3] - T_true[:, :3, 3]
    rmse_sq = (
        np.einsum("bij,bjk,bik->b", A, M2s, A)
        + 2.0 * np.einsum("bi,bij,bj->b", b, A, mus)
        + (b * b).sum(1)
    )
    rmses = np.sqrt(np.maximum(rmse_sq, 0.0))
    over2 = int((rot_errs >= 2.0).sum())
    ok_mask = rot_errs < 2.0
    budget = max(1, round(0.005 * len(rot_errs)))
    worst_recovered = float(rot_errs[ok_mask].max()) if ok_mask.any() else float("inf")
    rmse_recovered = float(rmses[ok_mask].max()) if ok_mask.any() else float("inf")
    return {
        "rot_err_deg_worst_pair": float(rot_errs.max()),
        "rot_err_deg_worst_recovered": worst_recovered,
        "align_rmse_worst_pair": float(rmses.max()),
        "align_rmse_worst_recovered": rmse_recovered,
        "fitness_min": float(np.asarray(result.ransac_fitness).min()),
        "pairs_over_2deg": over2,
        "hard_pair_budget": budget,
        "quality_ok": bool(
            over2 <= budget and bool(ok_mask.any()) and rmse_recovered < 0.1
        ),
    }


def measure_fused_device_rate(
    config: PipelineConfig,
    *,
    window: int,
    down_cap: int,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 2,
    approx_score: bool = True,
    rescue_restarts: int | None = None,
    rescue_modes: int = 6,
    sample_mode: str = "roll",
    dense_features: bool = True,
    reps: int = 3,
    device=None,
) -> float:
    """Device-only pairs/s of the fused window: features + one fused step
    over ``window`` pairs of random clouds already on the device (no upload
    in the timed loop), median of ``reps`` runs after one warm run."""
    dev = thread_device(device)
    step = _FusedWindow(
        config, ransac_iterations, icp_iterations, icp_solves_per_nn, approx_score,
        config.ransac.rescue_restarts if rescue_restarts is None else rescue_restarts,
        rescue_modes=rescue_modes, sample_mode=sample_mode, dense_features=dense_features)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(
        rng.normal(size=(2 * window, down_cap, 3)).astype(np.float32) * 0.5).to(dev)
    msk = torch.ones((2 * window, down_cap), dtype=torch.bool, device=dev)
    bits = _drawn([step.bits_shape(down_cap)], window, torch.Generator().manual_seed(3))[0]

    def run():
        return step(pts, msk, bits, dev)[1].cpu()

    run()  # warm
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        run()
        times.append(time.monotonic() - t0)
    return window / float(np.median(times))
