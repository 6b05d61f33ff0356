"""Dense nearest-neighbour search, batched (port of tpu3dm/ops/nn.py, dense tier).

These are the plain PyTorch versions: the [..., Nq, Nt] distance matrix is
materialized.  They are the CPU path of the lane wrappers
(ops/nn_lane.py) and the versions the CUDA kernels are held against.
"""

from __future__ import annotations

import torch

# Squared norm given to masked rows and columns: they never win a minimum,
# and BIG + BIG stays finite in fp32.
BIG = 1.0e30
# Below this feature width the distance is expanded per dimension
# (sum_d (q_d - t_d)^2); at and above it through a matmul cross term.
SMALL_D_MAX = 8


def lane_slices(n_lanes: int, entries_per_lane: int, max_entries: int = 1 << 26):
    """Slices of the pair dimension whose dense temporaries stay under
    ``max_entries`` fp32 entries (256 MB), so a plain version never builds
    a [B, ...] tensor of many GB."""
    step = max(1, max_entries // max(entries_per_lane, 1))
    return [slice(lo, min(lo + step, n_lanes)) for lo in range(0, n_lanes, step)]


def _sq_norms(points: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Squared norms with masked rows pushed unreachably far away."""
    sq = torch.sum(points * points, dim=-1)
    if mask is not None:
        sq = torch.where(mask, sq, BIG)
    return sq


def nn_search_dense(
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN of each query row among the valid targets ([..., Nq, d] x
    [..., Nt, d]).  Masked queries get arbitrary results.

    Returns (d2 [..., Nq] float32, idx [..., Nq] int32); ties go to the
    smaller target index.  For d < SMALL_D_MAX the distance is the direct
    sum of squared differences plus a 0 / BIG target bias, each step rounded
    on its own — the arithmetic of the 3-D CUDA kernel.
    """
    d = query.shape[-1]
    if d < SMALL_D_MAX:
        bias = torch.zeros(target.shape[:-1], dtype=query.dtype, device=query.device)
        if target_mask is not None:
            bias = torch.where(target_mask, bias, BIG)
        d2 = bias[..., None, :]
        for k in range(d):
            diff = query[..., :, k, None] - target[..., None, :, k]
            d2 = d2 + diff * diff
        idx = torch.argmin(d2, dim=-1).to(torch.int32)
        return torch.clamp_min(torch.amin(d2, dim=-1), 0.0), idx
    tsq = _sq_norms(target, target_mask)
    cross = query @ target.transpose(-1, -2)
    d2 = tsq[..., None, :] - 2.0 * cross
    idx = torch.argmin(d2, dim=-1).to(torch.int32)
    best = torch.amin(d2, dim=-1) + torch.sum(query * query, dim=-1)
    return torch.clamp_min(best, 0.0), idx


def nn_mutual_mask(
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward NN + mutuality mask from ONE distance matrix, min-only (fp32).

    Row i is mutual iff its best distance is the best anyone achieves to its
    chosen column: d2[i, idx[i]] <= colmin[idx[i]].  On exact distance ties
    every tying row passes.

    Returns (idx_fwd [..., Na] int32, mutual [..., Na] bool).
    """
    asq = _sq_norms(a, mask_a)
    bsq = _sq_norms(b, mask_b)
    cross = a @ b.transpose(-1, -2)
    d2 = asq[..., :, None] + bsq[..., None, :] - 2.0 * cross
    idx = torch.argmin(d2, dim=-1)
    dmin = torch.amin(d2, dim=-1)
    colmin = torch.amin(d2, dim=-2)
    mutual = dmin <= torch.gather(colmin, -1, idx)
    if mask_a is not None:
        mutual = mutual & mask_a
    return idx.to(torch.int32), mutual
