"""k nearest neighbours within a radius (port of tpu3dm/ops/topk.py).

Open3D ``KDTreeSearchParamHybrid(radius, max_nn)`` semantics: the k NEAREST
points within ``radius``.  In JAX this is XLA ``lax.top_k``, not a Pallas
kernel, so it stays plain PyTorch: one [..., Nq, Nt] distance slab (a plain
matmul cross term) and a STABLE sort, so distance ties go to the smaller
target index as ``lax.top_k`` gives them (``torch.topk`` promises no order
among ties).
"""

from __future__ import annotations

import math

import torch

from tpu3dm_torch.ops.nn import BIG, _sq_norms


def nn_topk(
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
    *,
    k: int,
    radius: float | None = None,
    self_pairs: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest valid targets of each query, optionally radius-bounded.

    ``self_pairs``: query row i is target row i (a cloud against itself), and
    a valid row's distance to itself is pinned to exactly 0.  Computed, it
    is |a|^2 + |a|^2 - 2 a.a, where the matmul's rounding differs from the
    norm's: the residue reaches ~1e-4 some 30 units from the origin, and
    FPFH's d2 > eps test would take the row for its own neighbour with a
    1 / d2 weight.  XLA's CPU and TPU arithmetic leave JAX's residue at 0.

    Returns (d2 [..., Nq, k] ascending, idx [..., Nq, k] int64,
    valid [..., Nq, k]): slots beyond the in-radius neighbours have
    valid=False and d2 = BIG; masked queries get all-invalid rows.
    """
    k = min(k, target.shape[-2])
    tsq = _sq_norms(target, target_mask)
    qsq = torch.sum(query * query, dim=-1)
    r2 = BIG if radius is None else float(torch.tensor(radius, dtype=torch.float32) ** 2)
    d2 = qsq[..., :, None] + tsq[..., None, :] - 2.0 * (query @ target.transpose(-1, -2))
    d2 = torch.where(d2 <= r2, d2, BIG)
    d2 = torch.clamp_min(d2, 0.0)
    d2 = torch.where(tsq[..., None, :] >= BIG, BIG, d2)
    if self_pairs:
        diag = d2.diagonal(dim1=-2, dim2=-1)
        diag.copy_(torch.where(tsq >= BIG, BIG, 0.0))
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    d2, idx = d2[..., :k], idx[..., :k]
    valid = d2 < BIG
    if query_mask is not None:
        valid = valid & query_mask[..., None]
    return d2, idx, valid


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [..., N, C] at kNN slots idx [..., Nq, K] of the same
    leading shape: [..., Nq, K, C] (``x[idx]`` for one cloud)."""
    if x.ndim == 2:
        return x[idx]
    n, c = x.shape[-2:]
    lead = x.shape[:-2]
    off = torch.arange(math.prod(lead), device=idx.device).reshape(lead + (1, 1)) * n
    return x.reshape(-1, c)[idx + off]
