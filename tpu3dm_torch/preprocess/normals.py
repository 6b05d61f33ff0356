"""Normals from kNN slots (port of tpu3dm/preprocess/normals.py:normals_from_knn).

The covariance of each point's hybrid-search neighbours; the normal is its
smallest eigenvector (ops/eigh3), oriented outward from the cloud centroid.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.ops.eigh3 import smallest_eigvec_sym3


def _knn_covariance(points: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] covariance of the valid neighbour slots (idx, valid [N, K])."""
    pj = points[idx]  # [N, K, 3]
    w = valid.to(torch.float32)
    cnt = torch.clamp_min(torch.sum(w, dim=1), 1.0)
    mean = torch.einsum("nk,nkd->nd", w, pj) / cnt[:, None]
    c = (pj - mean[:, None, :]) * w[..., None]
    return torch.einsum("nki,nkj->nij", c, c) / cnt[:, None, None]


def normals_from_knn(pc: PointCloud, idx: torch.Tensor, valid: torch.Tensor) -> PointCloud:
    """Normals of one cloud ([N, 3] points) from precomputed kNN slots."""
    _, v = smallest_eigvec_sym3(_knn_covariance(pc.points, idx, valid))
    outward = pc.points - pc.centroid()[None, :]
    flip = torch.sum(v * outward, dim=1) < 0.0
    v = torch.where(flip[:, None], -v, v)
    v = torch.where(pc.mask[:, None], v, 0.0)
    return pc.with_(normals=v)
