"""Feature-space correspondences (port of tpu3dm/registration/correspondence.py).

Top-1 NN in FPFH space, optionally mutual: a pair survives when each is the
other's nearest neighbour.  Up to DENSE_MAX_ENTRIES entries both directions
come from one distance matrix; above it from two tiled searches (kernel
csrc/nn_tiled.cu, d >= 8, on CUDA).  Noise injection is not ported.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.ops.nn import nn_mutual, nn_search


def feature_correspondences(
    src: PointCloud,
    tgt: PointCloud,
    *,
    mutual_filter: bool = False,
    noise_ratio: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Correspondence pairs from FPFH nearest neighbours.

    Returns (pairs [Ns, 2] int64 rows [src_idx, tgt_idx], valid [Ns] bool).
    """
    if noise_ratio > 0.0:
        raise NotImplementedError("feature_correspondences: noise_ratio > 0 is not ported")
    ns = src.capacity
    rows = torch.arange(ns, device=src.points.device)
    valid = src.mask
    if mutual_filter:
        idx_fwd, idx_bwd = nn_mutual(src.features, tgt.features, src.mask, tgt.mask)
        idx_fwd = idx_fwd.to(torch.int64)
        valid = valid & (idx_bwd.to(torch.int64)[idx_fwd] == rows)
    else:
        _, idx_fwd = nn_search(src.features, tgt.features, src.mask, tgt.mask)
        idx_fwd = idx_fwd.to(torch.int64)
    return torch.stack([rows, idx_fwd], dim=1), valid


def gather_pairs(
    src: PointCloud, tgt: PointCloud, pairs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (p, q) points of the correspondence pairs."""
    return src.points[pairs[:, 0]], tgt.points[pairs[:, 1]]
