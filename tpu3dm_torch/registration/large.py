"""Registration of large (100k-10M point) clouds (port of tpu3dm/registration/large.py).

``register_arrays_large``: voxel downsample and shared-kNN features, two-mode
RANSAC with ICP-verified restarts, point-to-plane ICP on the downsampled
clouds, donor normals, then block-sparse ICP at full resolution.  The
full-resolution search is ``ops.nn_sparse.nn_blocksparse`` (kernel
csrc/nn_blocksparse.cu on CUDA); the downsampled searches and the donor
normals go through ``ops.nn.nn_search`` (csrc/nn_tiled.cu above 16M
entries).  Each cloud is KD-partitioned once: the source's blocks move
rigidly under ICP and stay compact.  On CUDA every ICP of a call (the
verification, the polish and the full-resolution ICP) replays its
iterations as a CUDA graph (``registration.icp.icp_loop``'s
``cuda_graph``): the same kernels on the same values as the eager loop.

Two routes, picked by the inputs' type, with no fallback between them:
host arrays take the host voxel grid (``voxel_downsample_host``) and the
host KD partition (``kd_perm``, csrc/host.cpp), then upload; tensors (a
caller whose clouds are already on the card) take the same grid on their
device (``voxel_downsample`` + ``compact``) and the same leaves by
``kd_perm_device``, and never leave it.

Spans (``utils/profiler.py``, recorded only while recording is on):
``large.register`` around a call, and inside it ``large.downsample``,
``large.features``, ``large.coarse`` (verified RANSAC and the downsampled
point-to-plane polish), ``large.partition`` (both partitions, gathers and
pads, and the donor normals) and ``large.fine``.  Counters: ``large.pairs``
(calls), ``large.points`` (full-resolution points of both clouds),
``large.blocks`` (the target's KD blocks, among which each block-sparse
search picks its candidates) and ``large.fine_iters`` (the full-resolution
ICP's iterations).

With a ``mesh`` the full-resolution refinement is
``parallel.sharded_icp.icp_refine_sharded`` over the mesh's block axis: the
dense ring by default, the block-sparse ring with ``mesh_block_sparse``;
the donor normals are un-sorted to the caller's point order for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.ops.nn_sparse import kd_perm, kd_perm_device, nn_blocksparse, pad_sorted
from tpu3dm_torch.parallel.mesh import check_mesh
from tpu3dm_torch.parallel.multipair import draw_bits, f32_square
from tpu3dm_torch.parallel.sharded_icp import icp_refine_sharded
from tpu3dm_torch.preprocess.pipeline import down_features
from tpu3dm_torch.preprocess.voxel import compact, voxel_downsample, voxel_downsample_host
from tpu3dm_torch.registration.correspondence import feature_correspondences, gather_pairs
from tpu3dm_torch.registration.fused import RESCUE_OVERRIDE_MARGIN, RESCUE_TIE_RATIO
from tpu3dm_torch.registration.icp import icp_loop, icp_refine, masked_fit
from tpu3dm_torch.registration.ransac import chunk_count, ransac_two_mode
from tpu3dm_torch.registration.result import RegistrationResult
from tpu3dm_torch.utils.profiler import Profiler, new_call_id, recording

@dataclasses.dataclass
class LargeCloud:
    """A KD-partition-sorted, block-padded cloud on the device."""

    points: torch.Tensor  # [Np, 3] sorted + padded (SPARSE_PAD sentinel rows)
    n: int  # true point count
    block: int
    perm: np.ndarray | torch.Tensor  # sorted position -> original index (host, or
    # on the device for a cloud prepared from a tensor)
    normals: torch.Tensor | None = None  # sorted alongside points when present

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.points.shape[0], device=self.points.device) < self.n


def prepare_large_cloud(
    points: np.ndarray | torch.Tensor,
    *,
    block: int = 512,
    normals: np.ndarray | torch.Tensor | None = None,
    device=None,
) -> LargeCloud:
    """KD partition + pad, one call per cloud, reused across ICP.

    Host arrays: the host partition (``kd_perm``), gathered and padded on
    the host, then uploaded.  A tensor: ``kd_perm_device``, the gather and
    the pad on ``device``; ``perm`` stays there."""
    dev = resolve_device(device)
    if isinstance(points, torch.Tensor):
        pts = points.to(dev, torch.float32)
        perm = kd_perm_device(pts, block)
        sorted_pts = pad_sorted(pts[perm], block)
        nrm = None
        if normals is not None:
            nrm = torch.zeros_like(sorted_pts)
            nrm[: pts.shape[0]] = normals.to(dev, torch.float32)[perm]
        return LargeCloud(points=sorted_pts, n=pts.shape[0], block=block, perm=perm,
                          normals=nrm)
    pts = np.asarray(points, np.float32)
    perm = kd_perm(pts, block)
    sorted_pts = pad_sorted(pts[perm], block)
    nrm = None
    if normals is not None:
        nrm_np = np.zeros_like(sorted_pts)
        nrm_np[: pts.shape[0]] = np.asarray(normals, np.float32)[perm]
        nrm = torch.from_numpy(nrm_np).to(dev)
    return LargeCloud(
        points=torch.from_numpy(sorted_pts).to(dev), n=pts.shape[0], block=block,
        perm=perm, normals=nrm,
    )


def icp_refine_large(
    src: LargeCloud,
    tgt: LargeCloud,
    init_T,
    *,
    dist_thresh: float,
    max_iterations: int = 30,
    w: int = 8,
    point_to_plane: bool | None = None,
    cuda_graph: bool = False,
) -> RegistrationResult:
    """ICP between two prepared large clouds, correspondences from the
    block-sparse search.  point_to_plane defaults to whether the target has
    normals.  Converges on absolute fitness and RMSE deltas below 1e-6.
    ``cuda_graph``: see ``registration.icp.icp_loop``."""
    if point_to_plane is None:
        point_to_plane = tgt.normals is not None
    if point_to_plane and tgt.normals is None:
        raise ValueError("point_to_plane ICP needs target normals")
    if src.block != tgt.block:
        raise ValueError(f"block sizes differ: {src.block} and {tgt.block}")
    thresh_sq = f32_square(dist_thresh)
    src_mask = src.mask
    denom = float(np.float32(max(src.n, 1)))

    def correspond(T):
        # Sentinel source rows must stay sentinels (T would move them).
        pts = torch.where(src_mask[:, None], se3.apply(T, src.points), src.points)
        d2, idx, _ = nn_blocksparse(pts, tgt.points, block=src.block, w=w)
        m = (d2 < thresh_sq) & src_mask
        return pts, idx.to(torch.int64), m, *masked_fit(d2, m, denom)

    return icp_loop(
        correspond, tgt.points, tgt.normals if point_to_plane else None,
        torch.as_tensor(init_T, dtype=torch.float32, device=src.points.device),
        max_iterations=max_iterations, relative_fitness=1e-6, relative_rmse=1e-6,
        cuda_graph=cuda_graph,
    )


def coarse_pose_with_verification(
    src_down: PointCloud,
    tgt_down: PointCloud,
    config: PipelineConfig,
    *,
    restarts: int = 4,
    verify_iters: int = 10,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    cuda_graph: bool = False,
) -> RegistrationResult:
    """Multi-restart two-mode RANSAC with short-ICP verification.

    Near-symmetric geometry (a dental arch) gives RANSAC aliases whose inlier
    count ties the true pose; a few ICP iterations on the downsampled clouds
    separate them (the true pose converges, aliases stall).  The restarts
    run as lanes of one ``ransac_two_mode`` on the clouds' correspondences
    (each restart its own when ``noise_ratio`` corrupts them) and each gives
    its two modes; all candidates get a coarse-then-fine point-to-point
    ``icp_refine`` together, and the best (verified fitness, -RMSE) among
    the eligible candidates wins.

    sample_bits: [restarts, n_chunks_max, K, 2] int64 of uint32 values,
    restart r's at [r] (see ``ransac.ransac_two_mode``); drawn from
    ``generator`` when None, restart by restart after that restart's
    correspondence noise.  ``cuda_graph``: the verification's ICPs replay
    their iterations as CUDA graphs (``registration.icp.icp_loop``).
    """
    if restarts < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    if sample_bits is not None and sample_bits.shape[0] < restarts:
        raise ValueError(f"sample_bits holds {sample_bits.shape[0]} restarts, need {restarts}")
    rc = config.ransac
    p, q, bits = [], [], []
    for r in range(restarts):
        if r == 0 or rc.noise_ratio > 0.0:
            pairs, valid = feature_correspondences(
                src_down, tgt_down, mutual_filter=rc.mutual_filter,
                noise_ratio=rc.noise_ratio, generator=generator,
            )
            pr, qr = gather_pairs(src_down, tgt_down, pairs)
        p.append(pr)
        q.append(qr)
        bits.append(draw_bits((chunk_count(rc.max_iterations, rc.batch_size), rc.batch_size, 2),
                              generator) if sample_bits is None else sample_bits[r])
    modes = ransac_two_mode(
        torch.stack(p), torch.stack(q), valid, torch.stack(bits),
        dist_thresh=rc.dist_thresh, max_iterations=rc.max_iterations,
        batch_size=rc.batch_size, confidence=rc.confidence,
        edge_length_ratio=rc.edge_length_ratio, use_checkers=rc.use_checkers,
    )
    # Candidate 2r + m: restart r's mode m.
    cand_T, cand_fit, cand_rmse, cand_iters = (
        torch.stack([getattr(mode, f) for mode in modes], dim=1).flatten(0, 1)
        for f in ("transformation", "fitness", "inlier_rmse", "iterations"))
    half = max(verify_iters // 2, 1)
    ver = icp_refine(src_down, tgt_down, cand_T, dist_thresh=rc.dist_thresh,
                     max_iterations=half, point_to_plane=False, cuda_graph=cuda_graph)
    ver = icp_refine(src_down, tgt_down, ver.transformation, dist_thresh=config.icp.dist_thresh,
                     max_iterations=max(verify_iters - half, 1), point_to_plane=False,
                     cuda_graph=cuda_graph)
    # One read: the candidates' RANSAC fitness, and each verified pose's
    # fitness and RMSE at the ICP threshold.
    ransac_fit, ver_fit, ver_rmse = torch.stack(
        [cand_fit.to(ver.fitness), ver.fitness, ver.inlier_rmse]).tolist()
    fit_max = max(ransac_fit)
    is_near = [f >= RESCUE_TIE_RATIO * fit_max for f in ransac_fit]
    ver_near_best = max(f for f, n in zip(ver_fit, is_near) if n)
    eligible = [k for k, n in enumerate(is_near)
                if n or ver_fit[k] >= RESCUE_OVERRIDE_MARGIN * ver_near_best]
    k = max(eligible, key=lambda k: (ver_fit[k], -ver_rmse[k]))
    return RegistrationResult(
        transformation=ver.transformation[k], fitness=cand_fit[k],
        inlier_rmse=cand_rmse[k], iterations=cand_iters[k],
    )


def downsample_large(points: np.ndarray | torch.Tensor, voxel_size: float, *,
                     device=None) -> PointCloud:
    """The voxel-grid cloud of a raw large cloud, padded to its bucketed
    capacity on ``device``: host arrays through the host grid
    (``voxel_downsample_host``), a tensor through the same grid on
    ``device`` (``voxel_downsample`` + ``compact``, one host read: the
    voxel count).  Both give the same means, bit for bit, from the same
    float32 points."""
    dev = resolve_device(device)
    if not isinstance(points, torch.Tensor):
        return voxel_downsample_host(points, voxel_size, device=dev)
    pts = points.to(dev, torch.float32)
    n = pts.shape[0]
    whole = PointCloud(points=pts, mask=torch.ones(n, dtype=torch.bool, device=dev),
                       normals=torch.zeros_like(pts),
                       features=torch.zeros((n, 0), dtype=torch.float32, device=dev))
    return compact(voxel_downsample(whole, voxel_size))


def donor_normals(cloud: LargeCloud, down: PointCloud) -> torch.Tensor:
    """Full-resolution normals by donation: each point borrows the normal of
    its nearest downsampled point (one tiled NN search per cloud).
    Point-to-plane is sign-invariant, so donor orientation does not matter."""
    _, idx = nn_search(cloud.points, down.points, None, down.mask)
    return down.normals[idx.to(torch.int64)]


def register_arrays_large(
    src_pts: np.ndarray | torch.Tensor,
    tgt_pts: np.ndarray | torch.Tensor,
    config: PipelineConfig | None = None,
    *,
    key: int | None = None,
    block: int = 512,
    w: int = 8,
    point_to_plane: bool = True,
    mesh=None,
    mesh_block_sparse: bool = False,
    restarts: int = 4,
    device=None,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Full registration of two large raw clouds (100k-10M points).

    Coarse stage on the voxel-downsampled clouds (FPFH correspondences,
    verified two-mode RANSAC, point-to-plane ICP); refinement by block-sparse
    ICP on the full-resolution clouds, point-to-plane with donated normals
    by default.

    ``src_pts`` / ``tgt_pts``: [N, 3] host arrays (the host voxel grid and KD
    partition, then uploads), or both [N, 3] tensors (the voxel grid and the
    KD partition on ``device``, where they are moved if they lie elsewhere;
    no host round trip of the clouds).  A tensor route takes no ``mesh``:
    the sharded refinement partitions on the host.

    Randomness: ``sample_bits`` ([restarts, n_chunks_max, K, 2], see
    ``coarse_pose_with_verification``), else ``generator`` (one on the card
    draws the bits there), else a host ``torch.Generator`` seeded with
    ``key`` (0 when None).  JAX's PRNG keys
    cannot be reproduced in torch.  ``device=None`` means CUDA and raises
    when CUDA is absent; the coarse stage runs there.  ``mesh``: the
    refinement sharded over its block axis (``icp_refine_sharded``, the
    block-sparse ring when ``mesh_block_sparse``); the result then lies on
    the mesh's home device.

    Returns (RegistrationResult of the refinement, coarse RegistrationResult).
    """
    on_device = isinstance(src_pts, torch.Tensor)
    if on_device != isinstance(tgt_pts, torch.Tensor):
        raise TypeError("register_arrays_large: pass both clouds as host arrays or both as "
                        "tensors")
    if mesh is not None:
        check_mesh("register_arrays_large", mesh)
        if on_device:
            raise ValueError("register_arrays_large: the mesh route partitions on the host; "
                             "pass host arrays with a mesh")
    dev = resolve_device(device)
    if config is None:
        config = PipelineConfig.with_voxel_size(0.3)
    if sample_bits is None and generator is None:
        generator = torch.Generator().manual_seed(0 if key is None else int(key))
    if on_device:
        src_pts = src_pts.to(dev, torch.float32)
        tgt_pts = tgt_pts.to(dev, torch.float32)
    pp = config.preprocess

    def features(down):
        return down_features(
            down, pp.normal_radius, pp.fpfh_radius,
            normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn,
            share_knn=pp.normal_radius <= pp.fpfh_radius,
        )

    with Profiler("large.register", call_id=new_call_id()):
        Profiler.count("large.pairs", 1)
        Profiler.count("large.points", src_pts.shape[0] + tgt_pts.shape[0])
        with Profiler("large.downsample"):
            src_down = downsample_large(src_pts, pp.voxel_size, device=dev)
            tgt_down = downsample_large(tgt_pts, pp.voxel_size, device=dev)
        with Profiler("large.features"):
            src_down, tgt_down = features(src_down), features(tgt_down)
        with Profiler("large.coarse"):
            coarse = coarse_pose_with_verification(
                src_down, tgt_down, config, restarts=restarts, sample_bits=sample_bits,
                generator=generator, cuda_graph=True,
            )
            # Point-to-plane polish on the downsampled clouds: point-to-point
            # ICP converges only linearly in rotation at full resolution.
            mid = icp_refine(
                src_down, tgt_down, coarse.transformation,
                dist_thresh=config.icp.dist_thresh, max_iterations=config.icp.max_iterations,
                point_to_plane=True, cuda_graph=True,
            )
        if mesh is not None:
            nrm = None
            with Profiler("large.partition"):
                if point_to_plane:
                    # donor_normals works in the KD-sorted order; the sharded
                    # ICP takes the caller's point order.
                    tgt_tmp = prepare_large_cloud(tgt_pts, block=block, device=dev)
                    n = tgt_tmp.n
                    nrm = np.empty((n, 3), np.float32)
                    nrm[tgt_tmp.perm] = donor_normals(tgt_tmp, tgt_down)[:n].cpu().numpy()
            with Profiler("large.fine"):
                fine = icp_refine_sharded(
                    mesh, src_pts, tgt_pts, mid.transformation, tgt_normals=nrm,
                    dist_thresh=config.icp.dist_thresh,
                    max_iterations=config.icp.max_iterations, point_to_plane=point_to_plane,
                    block_sparse=mesh_block_sparse, block=block, w=w,
                )
                if recording():
                    Profiler.count("large.fine_iters", int(fine.iterations))
            return fine, coarse
        with Profiler("large.partition"):
            src = prepare_large_cloud(src_pts, block=block, device=dev)
            tgt = prepare_large_cloud(tgt_pts, block=block, device=dev)
            if point_to_plane:
                tgt = dataclasses.replace(tgt, normals=donor_normals(tgt, tgt_down))
        with Profiler("large.fine"):
            Profiler.count("large.blocks", tgt.points.shape[0] // block)
            fine = icp_refine_large(
                src, tgt, mid.transformation,
                dist_thresh=config.icp.dist_thresh, max_iterations=config.icp.max_iterations,
                w=w, point_to_plane=point_to_plane, cuda_graph=True,
            )
            if recording():
                Profiler.count("large.fine_iters", int(fine.iterations))
    return fine, coarse
