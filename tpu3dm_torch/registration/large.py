"""Registration of large (100k-10M point) clouds (port of tpu3dm/registration/large.py).

``register_arrays_large``: voxel downsample and shared-kNN features, two-mode
RANSAC with ICP-verified restarts, point-to-plane ICP on the downsampled
clouds, donor normals, then block-sparse ICP at full resolution.  The
full-resolution search is ``ops.nn_sparse.nn_blocksparse`` (kernel
csrc/nn_blocksparse.cu on CUDA); the downsampled searches and the donor
normals go through ``ops.nn.nn_search`` (csrc/nn_tiled.cu above 16M
entries).  The KD partition of each cloud is host C++ (csrc/host.cpp),
done once per cloud: the source's blocks move rigidly under ICP and stay
compact.

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
from tpu3dm_torch.ops.nn_sparse import kd_perm, nn_blocksparse, pad_sorted
from tpu3dm_torch.parallel.mesh import check_mesh
from tpu3dm_torch.parallel.multipair import f32_square
from tpu3dm_torch.parallel.sharded_icp import icp_refine_sharded
from tpu3dm_torch.preprocess.pipeline import down_features
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host
from tpu3dm_torch.registration.fused import RESCUE_OVERRIDE_MARGIN, RESCUE_TIE_RATIO
from tpu3dm_torch.registration.evaluate import evaluate_registration
from tpu3dm_torch.registration.icp import icp_loop, icp_refine, masked_fit
from tpu3dm_torch.registration.ransac import global_registration_two_mode
from tpu3dm_torch.registration.result import RegistrationResult

@dataclasses.dataclass
class LargeCloud:
    """A KD-partition-sorted, block-padded cloud on the device."""

    points: torch.Tensor  # [Np, 3] sorted + padded (SPARSE_PAD sentinel rows)
    n: int  # true point count
    block: int
    perm: np.ndarray  # sorted position -> original index (host)
    normals: torch.Tensor | None = None  # sorted alongside points when present

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.points.shape[0], device=self.points.device) < self.n


def prepare_large_cloud(
    points: np.ndarray,
    *,
    block: int = 512,
    normals: np.ndarray | None = None,
    device=None,
) -> LargeCloud:
    """Host KD partition + pad, one call per cloud, reused across ICP."""
    dev = resolve_device(device)
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
) -> RegistrationResult:
    """ICP between two prepared large clouds, correspondences from the
    block-sparse search.  point_to_plane defaults to whether the target has
    normals.  Converges on absolute fitness and RMSE deltas below 1e-6."""
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
) -> RegistrationResult:
    """Multi-restart two-mode RANSAC with short-ICP verification.

    Near-symmetric geometry (a dental arch) gives RANSAC aliases whose inlier
    count ties the true pose; a few ICP iterations on the downsampled clouds
    separate them (the true pose converges, aliases stall).  Each restart
    contributes its two modes; each candidate gets a coarse-then-fine
    point-to-point ICP, and the best (fine fitness, verified fitness,
    -RMSE) among the eligible candidates wins.

    sample_bits: [restarts, n_chunks_max, K, 2] int64 of uint32 values,
    restart r's at [r] (see ``ransac.ransac_two_mode``); drawn from
    ``generator`` when None.
    """
    if restarts < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    if sample_bits is not None and sample_bits.shape[0] < restarts:
        raise ValueError(f"sample_bits holds {sample_bits.shape[0]} restarts, need {restarts}")
    cands = []
    for r in range(restarts):
        bits = None if sample_bits is None else sample_bits[r]
        cands.extend(global_registration_two_mode(src_down, tgt_down, config.ransac, bits, generator))
    fit_max = max(float(c.fitness) for c in cands)

    def verified(cand):
        half = max(verify_iters // 2, 1)
        ver = icp_refine(src_down, tgt_down, cand.transformation,
                         dist_thresh=config.ransac.dist_thresh, max_iterations=half,
                         point_to_plane=False)
        ver = icp_refine(src_down, tgt_down, ver.transformation,
                         dist_thresh=config.icp.dist_thresh,
                         max_iterations=max(verify_iters - half, 1), point_to_plane=False)
        fine = evaluate_registration(src_down, tgt_down, config.icp.dist_thresh,
                                     ver.transformation)
        return ver, (float(fine.fitness), float(ver.fitness), -float(ver.inlier_rmse))

    vers = [(cand, *verified(cand)) for cand in cands]
    is_near = [float(v[0].fitness) >= RESCUE_TIE_RATIO * fit_max for v in vers]
    vfine_near_best = max(v[2][0] for v, n in zip(vers, is_near) if n)
    eligible = [
        v for v, n in zip(vers, is_near)
        if n or v[2][0] >= RESCUE_OVERRIDE_MARGIN * vfine_near_best
    ]
    cand, ver, _ = max(eligible, key=lambda v: v[2])
    return RegistrationResult(
        transformation=ver.transformation, fitness=cand.fitness,
        inlier_rmse=cand.inlier_rmse, iterations=cand.iterations,
    )


def donor_normals(cloud: LargeCloud, down: PointCloud) -> torch.Tensor:
    """Full-resolution normals by donation: each point borrows the normal of
    its nearest downsampled point (one tiled NN search per cloud).
    Point-to-plane is sign-invariant, so donor orientation does not matter."""
    _, idx = nn_search(cloud.points, down.points, None, down.mask)
    return down.normals[idx.to(torch.int64)]


def register_arrays_large(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
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

    Randomness: ``sample_bits`` ([restarts, n_chunks_max, K, 2], see
    ``coarse_pose_with_verification``), else ``generator``, else a
    ``torch.Generator`` seeded with ``key`` (0 when None).  JAX's PRNG keys
    cannot be reproduced in torch.  ``device=None`` means CUDA and raises
    when CUDA is absent; the coarse stage runs there.  ``mesh``: the
    refinement sharded over its block axis (``icp_refine_sharded``, the
    block-sparse ring when ``mesh_block_sparse``); the result then lies on
    the mesh's home device.

    Returns (RegistrationResult of the refinement, coarse RegistrationResult).
    """
    if mesh is not None:
        check_mesh("register_arrays_large", mesh)
    dev = resolve_device(device)
    if config is None:
        config = PipelineConfig.with_voxel_size(0.3)
    if sample_bits is None and generator is None:
        generator = torch.Generator().manual_seed(0 if key is None else int(key))

    def down(points):
        pp = config.preprocess
        return down_features(
            voxel_downsample_host(points, pp.voxel_size, device=dev),
            pp.normal_radius, pp.fpfh_radius,
            normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn,
            share_knn=pp.normal_radius <= pp.fpfh_radius,
        )

    src_down, tgt_down = down(src_pts), down(tgt_pts)
    coarse = coarse_pose_with_verification(
        src_down, tgt_down, config, restarts=restarts, sample_bits=sample_bits,
        generator=generator,
    )
    # Point-to-plane polish on the downsampled clouds: point-to-point ICP
    # converges only linearly in rotation at full resolution.
    mid = icp_refine(
        src_down, tgt_down, coarse.transformation,
        dist_thresh=config.icp.dist_thresh, max_iterations=config.icp.max_iterations,
        point_to_plane=True,
    )
    if mesh is not None:
        nrm = None
        if point_to_plane:
            # donor_normals works in the KD-sorted order; the sharded ICP
            # takes the caller's point order.
            tgt_tmp = prepare_large_cloud(tgt_pts, block=block, device=dev)
            n = tgt_tmp.n
            nrm = np.empty((n, 3), np.float32)
            nrm[tgt_tmp.perm] = donor_normals(tgt_tmp, tgt_down)[:n].cpu().numpy()
        fine = icp_refine_sharded(
            mesh, src_pts, tgt_pts, mid.transformation, tgt_normals=nrm,
            dist_thresh=config.icp.dist_thresh, max_iterations=config.icp.max_iterations,
            point_to_plane=point_to_plane, block_sparse=mesh_block_sparse, block=block, w=w,
        )
        return fine, coarse
    src = prepare_large_cloud(src_pts, block=block, device=dev)
    tgt = prepare_large_cloud(tgt_pts, block=block, device=dev)
    if point_to_plane:
        tgt = dataclasses.replace(tgt, normals=donor_normals(tgt, tgt_down))
    fine = icp_refine_large(
        src, tgt, mid.transformation,
        dist_thresh=config.icp.dist_thresh, max_iterations=config.icp.max_iterations,
        w=w, point_to_plane=point_to_plane,
    )
    return fine, coarse
