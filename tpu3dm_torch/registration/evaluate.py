"""Registration evaluation, Open3D ``evaluate_registration`` and
``get_information_matrix_from_point_clouds`` parity (port of
tpu3dm/registration/evaluate.py)."""

from __future__ import annotations

import torch

from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.parallel.multipair import f32_square
from tpu3dm_torch.registration.icp import masked_fit
from tpu3dm_torch.registration.result import RegistrationResult


def evaluate_registration(
    src: PointCloud,
    tgt: PointCloud,
    max_distance: float,
    transformation: torch.Tensor | None = None,
) -> RegistrationResult:
    """Grade ``transformation`` (identity when None) on a pair: fitness =
    inlier correspondences / valid source points, inlier_rmse = RMSE of the
    inlier correspondence distances, iterations 0."""
    dev = src.points.device
    T = (torch.eye(4, dtype=torch.float32, device=dev) if transformation is None
         else torch.as_tensor(transformation, dtype=torch.float32, device=dev))
    pts = se3.apply(T, src.points).contiguous()
    d2, _ = nn_search(pts, tgt.points, src.mask, tgt.mask)
    m = (d2 < f32_square(max_distance)) & src.mask
    fitness, rmse = masked_fit(d2, m, torch.clamp_min(torch.sum(src.mask), 1).to(torch.float32))
    return RegistrationResult(
        transformation=T, fitness=fitness, inlier_rmse=rmse,
        iterations=torch.tensor(0, dtype=torch.int32),
    )


def information_matrix(
    src: PointCloud,
    tgt: PointCloud,
    max_distance: float,
    transformation: torch.Tensor,
) -> torch.Tensor:
    """6x6 pose-graph edge information matrix (Open3D semantics): the sum
    over inlier correspondences of G^T G, G = [I | -[q]_x] at the matched
    TARGET point q."""
    dev = src.points.device
    T = torch.as_tensor(transformation, dtype=torch.float32, device=dev)
    pts = se3.apply(T, src.points).contiguous()
    d2, idx = nn_search(pts, tgt.points, src.mask, tgt.mask)
    w = ((d2 < f32_square(max_distance)) & src.mask).to(torch.float32)
    q = tgt.points[idx.to(torch.int64)]
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(q.shape[0], 3, 3)
    G = torch.cat([eye, -se3.hat(q)], dim=2)  # [N, 3, 6]
    return torch.einsum("nij,nik->jk", G * w[:, None, None], G)
