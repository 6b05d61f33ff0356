"""ICP refinement, point-to-plane and point-to-point (port of tpu3dm/registration/icp.py).

Each iteration: transform -> NN search (``ops.nn.nn_search``: dense up to
16M entries, the tiled kernel above) -> weighted 6x6 normal equations ->
SE(3) exponential update.  The JAX ``while_loop`` becomes a Python loop
whose convergence test (Open3D's: ABSOLUTE deltas of fitness and RMSE
below the fields named relative_*) reads two scalars on the host once per
iteration.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import IcpConfig
from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.parallel.multipair import f32_square
from tpu3dm_torch.registration.result import RegistrationResult


def masked_fit(d2: torch.Tensor, m: torch.Tensor, n_src) -> tuple[torch.Tensor, torch.Tensor]:
    """(fitness, inlier RMSE) of correspondences with squared distances d2
    and inlier mask m, over n_src valid source points."""
    fitness = torch.sum(m.to(torch.float32)) / n_src
    rmse = torch.sqrt(torch.sum(torch.where(m, d2, 0.0)) / torch.clamp_min(torch.sum(m), 1))
    return fitness, rmse


def gauss_newton_step(T, pts, q, n, m, point_to_plane: bool) -> torch.Tensor:
    """exp(xi) @ T for the Gauss-Newton step xi of the weighted residuals of
    moved source points ``pts`` against their matches ``q`` (normals ``n``
    for point-to-plane), inlier weights ``m`` [N] bool."""
    w = m.to(torch.float32)
    if point_to_plane:
        r = torch.sum((pts - q) * n, dim=1)  # signed plane residual
        J = torch.cat([n, torch.cross(pts, n, dim=1)], dim=1)  # [N, 6]
    else:
        eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(pts.shape[0], 3, 3)
        J = torch.cat([eye, -se3.hat(pts)], dim=2).reshape(-1, 6)
        r = (pts - q).reshape(-1)
        w = torch.repeat_interleave(w, 3)
    A = torch.einsum("n,ni,nj->ij", w, J, J)
    b = -torch.einsum("n,ni,n->i", w, J, r)
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    A = A + 1e-6 * torch.trace(A) / 6.0 * eye6 + 1e-12 * eye6
    xi = torch.linalg.solve_ex(A, b).result  # no host sync; a failed solve is caught below
    xi = torch.where(torch.all(torch.isfinite(xi)), xi, 0.0)
    return se3.exp_se3(xi) @ T


def icp_loop(
    correspond, tgt_points, tgt_normals, T, *,
    max_iterations: int, relative_fitness: float, relative_rmse: float,
) -> RegistrationResult:
    """The ICP iteration shared by ``icp_refine`` and the large-cloud ICP.

    ``correspond(T)`` gives (moved source points, match indices into
    ``tgt_points``, inlier mask, fitness, RMSE); point-to-plane when
    ``tgt_normals`` is given.  Stops after ``max_iterations`` or when both
    fitness and RMSE moved by less than their thresholds (Open3D's test:
    absolute deltas, fp32), and grades the final transform.
    """
    f_cur = r_cur = torch.tensor(-1.0, dtype=torch.float32, device=T.device)
    it = 0
    while it < max_iterations:
        pts, idx, m, f_new, r_new = correspond(T)
        n = None if tgt_normals is None else tgt_normals[idx]
        T = gauss_newton_step(T, pts, tgt_points[idx], n, m, tgt_normals is not None)
        done = it > 0 and bool((torch.abs(f_new - f_cur) < relative_fitness)
                               & (torch.abs(r_new - r_cur) < relative_rmse))
        it += 1
        f_cur, r_cur = f_new, r_new
        if done:
            break
    _, _, _, fitness, rmse = correspond(T)
    return RegistrationResult(
        transformation=T, fitness=fitness, inlier_rmse=rmse,
        iterations=torch.tensor(it, dtype=torch.int32),
    )


def icp_refine(
    src: PointCloud,
    tgt: PointCloud,
    init_T: torch.Tensor,
    *,
    dist_thresh: float,
    max_iterations: int = 30,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    point_to_plane: bool = True,
) -> RegistrationResult:
    """Refine ``init_T`` (target <- source) by ICP.

    fitness = inliers / valid source points, inlier_rmse = RMSE of the inlier
    correspondence distances (Open3D RegistrationResult semantics).
    """
    thresh_sq = f32_square(dist_thresh)
    n_src = torch.clamp_min(torch.sum(src.mask), 1).to(torch.float32)

    def correspond(T):
        pts = se3.apply(T, src.points).contiguous()
        d2, idx = nn_search(pts, tgt.points, src.mask, tgt.mask)
        m = (d2 < thresh_sq) & src.mask
        return pts, idx.to(torch.int64), m, *masked_fit(d2, m, n_src)

    return icp_loop(
        correspond, tgt.points, tgt.normals if point_to_plane else None,
        torch.as_tensor(init_T, dtype=torch.float32, device=src.points.device),
        max_iterations=max_iterations, relative_fitness=relative_fitness,
        relative_rmse=relative_rmse,
    )


def refine_registration(
    src: PointCloud, tgt: PointCloud, init_T: torch.Tensor, config: IcpConfig
) -> RegistrationResult:
    """ICP with the configuration's threshold, budget, criteria and metric."""
    return icp_refine(
        src, tgt, init_T,
        dist_thresh=config.dist_thresh,
        max_iterations=config.max_iterations,
        relative_fitness=config.relative_fitness,
        relative_rmse=config.relative_rmse,
        point_to_plane=config.point_to_plane,
    )
