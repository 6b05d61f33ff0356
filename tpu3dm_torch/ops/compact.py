"""Stable compaction permutation, batched (port of tpu3dm/ops/compact.py)."""

from __future__ import annotations

import torch


def compaction_permutation(valid: torch.Tensor) -> torch.Tensor:
    """Permutation ``perm [..., M]`` such that ``gather(a, perm)`` puts valid
    rows first, stable within both groups (the stable argsort of ``~valid``),
    built from prefix sums and one scatter."""
    m = valid.shape[-1]
    vi = valid.to(torch.int64)
    n_valid = torch.sum(vi, dim=-1, keepdim=True)
    rank_valid = torch.cumsum(vi, dim=-1) - 1
    rank_invalid = n_valid + torch.cumsum(1 - vi, dim=-1) - 1
    dest = torch.where(valid, rank_valid, rank_invalid)
    src = torch.arange(m, device=valid.device).expand(valid.shape)
    return torch.zeros_like(dest).scatter_(-1, dest, src)
