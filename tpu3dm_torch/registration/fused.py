"""Fused registration step over a batch of pairs (port of tpu3dm/registration/fused.py).

``fused_register_step`` registers B preprocessed pairs at once: mutual FPFH
correspondences (CUDA kernel csrc/lane_mutual.cu) -> fixed-budget RANSAC
with the exact Horn refit (score kernel csrc/ransac_score.cu) -> point-to-
plane ICP (3-D NN kernel csrc/lane_nn.cu).  It is the JAX step with
``nn_impl="lane"``, ``mutual_filter=True`` and ``rescue_restarts=0``, with
the pair dimension written out instead of ``vmap``.

The step runs in a frame shifted by the target centroid rounded to a
multiple of 64: far from the origin the point-to-plane Jacobian rows
[n, p x n] pivot about a distant origin and the 6x6 normal equations lose
fp32 precision; near the origin the rounded shift is an exact no-op.
"""

from __future__ import annotations

import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core import se3
from tpu3dm_torch.ops.nn_lane import nn_mutual_mask_lane, nn_search_lane
from tpu3dm_torch.parallel.multipair import f32_square, ransac_pair_step


def _pn_center(tgt_pts: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
    """Masked target centroid [B, 3], rounded to a multiple of 64."""
    w = tgt_mask.to(torch.float32)[..., None]
    c = torch.sum(tgt_pts * w, dim=-2) / torch.clamp_min(torch.sum(w, dim=-2), 1.0)
    return torch.round(c / 64.0) * 64.0


def _solve6_cholesky(A, b):
    """Solve the symmetric 6x6 systems (nested lists of [B] tensors, lower
    triangle used) with an unrolled Cholesky."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp_min(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = []
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _p2pl_delta_planar(pts, q, n, w):
    """Point-to-plane Gauss-Newton step xi [B, 6] from weighted
    correspondences (pts, q, n [B, M, 3], w [B, M]): the 21 unique entries of
    J^T W J and the 6 of -J^T W r as masked reductions, then the Cholesky
    solve; a lane with a non-finite step moves by zero."""
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    J = (nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx)
    r = (px - q[..., 0]) * nx + (py - q[..., 1]) * ny + (pz - q[..., 2]) * nz
    A = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            A[i][j] = torch.sum(w * J[i] * J[j], dim=-1)
    trA = A[0][0] + A[1][1] + A[2][2] + A[3][3] + A[4][4] + A[5][5]
    reg = 1e-6 * trA / 6.0 + 1e-12
    for i in range(6):
        A[i][i] = A[i][i] + reg
    b = [-torch.sum(w * J[i] * r, dim=-1) for i in range(6)]
    xi = torch.stack(_solve6_cholesky(A, b), dim=-1)
    finite = torch.all(torch.isfinite(xi), dim=-1, keepdim=True)
    return torch.where(finite, xi, 0.0)


def mutual_correspondences(src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts):
    """Mutual FPFH correspondences: (q_all [B, M, 3] matched target points,
    valid [B, M] = src_mask & mutual)."""
    idx, mutual = nn_mutual_mask_lane(src_feat, tgt_feat, src_mask, tgt_mask)
    q_all = torch.gather(tgt_pts, 1, idx.to(torch.int64)[..., None].expand(-1, -1, 3))
    return q_all, src_mask & mutual


def icp_polish(
    T, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    icp_thresh: float, icp_iterations: int, icp_solves_per_nn: int,
):
    """Fixed-iteration point-to-plane ICP from T [B, 4, 4]; each 3-D NN search
    serves ``icp_solves_per_nn`` Gauss-Newton solves.  Returns (T, rmse [B])."""
    thresh_sq = f32_square(icp_thresh)
    tgt_pn = torch.cat([tgt_pts, tgt_normals], dim=-1)

    def solve_step(T, pts, q, n):
        d2 = torch.sum((pts - q) ** 2, dim=-1)
        m = (d2 < thresh_sq) & src_mask
        xi = _p2pl_delta_planar(pts, q, n, m.to(torch.float32))
        rmse = torch.sqrt(
            torch.sum(torch.where(m, d2, 0.0), dim=-1)
            / torch.clamp_min(torch.sum(m, dim=-1), 1)
        )
        return se3.exp_se3(xi) @ T, rmse

    n_outer = max(1, -(-icp_iterations // max(1, icp_solves_per_nn)))
    rmse = None
    for _ in range(n_outer):
        pts = se3.apply(T, src_pts)
        _, idx = nn_search_lane(pts, tgt_pts, src_mask, tgt_mask)
        g = torch.gather(tgt_pn, 1, idx.to(torch.int64)[..., None].expand(-1, -1, 6))
        q, n = g[..., :3], g[..., 3:]
        T, rmse = solve_step(T, pts, q, n)
        for _ in range(icp_solves_per_nn - 1):
            T, rmse = solve_step(T, se3.apply(T, src_pts), q, n)
    return T, rmse


def fused_register_step(
    src_pts,
    src_feat,
    src_mask,
    src_normals,
    tgt_pts,
    tgt_feat,
    tgt_mask,
    tgt_normals,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float = 0.45,
    icp_thresh: float = 0.12,
    ransac_iterations: int = 4096,
    ransac_batch: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 1,
    mutual_filter: bool = True,
    approx_score: bool = False,
    approx_features: bool = False,
    rescue_restarts: int = 0,
    nn_impl: str = "lane",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register B preprocessed pairs: correspondences -> RANSAC -> ICP.

    Args:
      src_* / tgt_*: [B, M, ...] / [B, N, ...] arrays or tensors: points
        [., ., 3], FPFH features [., ., 33], masks [., .] and normals
        [., ., 3] (source normals are unused, as in JAX).
      sample_bits / generator: RANSAC sample bits, see
        ``parallel.multipair.ransac_pair_step``.
      approx_score: round the score features to bf16 (the JAX bf16 score).
      approx_features: accepted and ignored; the mutual search is fp32, as
        the TPU lane kernel's is.
      device: None means CUDA and raises without it; "cpu" runs the plain
        PyTorch versions.

    Only ``nn_impl="lane"``, ``mutual_filter=True`` and
    ``rescue_restarts=0`` are ported; other values raise NotImplementedError.

    Returns (T [B, 4, 4] target <- source, ransac_fitness [B], icp_rmse [B]).
    """
    del src_normals, approx_features
    if nn_impl != "lane":
        raise NotImplementedError(f"fused_register_step: nn_impl={nn_impl!r} is not ported")
    if not mutual_filter:
        raise NotImplementedError("fused_register_step: mutual_filter=False is not ported")
    if rescue_restarts > 0:
        raise NotImplementedError("fused_register_step: rescue_restarts > 0 is not ported")
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def flag(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev)

    src_pts, src_feat, src_mask = f32(src_pts), f32(src_feat).contiguous(), flag(src_mask)
    tgt_pts, tgt_feat, tgt_mask = f32(tgt_pts), f32(tgt_feat).contiguous(), flag(tgt_mask)
    tgt_normals = f32(tgt_normals)

    # T_world = Shift(frame_c) . T . Shift(-frame_c) at return.
    frame_c = _pn_center(tgt_pts, tgt_mask)
    src_pts = (src_pts - frame_c[:, None, :]).contiguous()
    tgt_pts = (tgt_pts - frame_c[:, None, :]).contiguous()

    q_all, valid = mutual_correspondences(src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts)
    n_valid = torch.clamp_min(torch.sum(valid, dim=-1), 1)
    T, count = ransac_pair_step(
        src_pts, q_all, valid, sample_bits, generator,
        dist_thresh=dist_thresh,
        iterations=ransac_iterations,
        batch_size=ransac_batch,
        approx_score=approx_score,
    )
    fitness = count.to(torch.float32) / n_valid.to(torch.float32)

    if icp_iterations == 0:
        rmse = torch.zeros_like(fitness)
    else:
        T, rmse = icp_polish(
            T, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
            icp_thresh=icp_thresh,
            icp_iterations=icp_iterations,
            icp_solves_per_nn=icp_solves_per_nn,
        )
    T = T.clone()
    T[:, :3, 3] = T[:, :3, 3] + frame_c - torch.einsum("bij,bj->bi", T[:, :3, :3], frame_c)
    return T, fitness, rmse
