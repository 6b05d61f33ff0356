"""Fixed-budget RANSAC over a batch of pairs (port of tpu3dm/parallel/multipair.py).

``ransac_pair_step`` is the JAX single-pair step with the pair dimension
written out: every tensor carries a leading [B] lane axis, the hypothesis
chunks run as a Python loop, and the sample bits come from the caller or a
``torch.Generator`` in place of a ``jax.random`` key.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dm_torch.ops.compact import compaction_permutation
from tpu3dm_torch.ops.ransac_score import corres_features
from tpu3dm_torch.registration.hypotheses import (
    fit_score_gathers,
    refit_inliers,
    rolled_sample_gathers,
    sample_row_count,
    winner_T,
)


def f32_square(x: float) -> float:
    """``jnp.float32(x) ** 2`` as a Python float: the exact fp32 threshold
    the JAX package compares against."""
    return float(np.float32(x) * np.float32(x))


def draw_sample_bits(
    n_lanes: int, n_chunks: int, m_s: int, generator: torch.Generator | None = None
) -> torch.Tensor:
    """[n_lanes, n_chunks, m_s] int64 holding uniform uint32 values, drawn on
    the CPU from ``generator`` (torch's default generator when None).  The
    two-mode RANSAC draws its [n_chunks, K, 2] bits the same way."""
    return torch.randint(0, 1 << 32, (n_lanes, n_chunks, m_s), generator=generator,
                         dtype=torch.int64)


def ransac_pair_step(
    p_all: torch.Tensor,
    q_all: torch.Tensor,
    valid: torch.Tensor,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float,
    iterations: int,
    batch_size: int,
    edge_length_ratio: float = 0.9,
    approx_score: bool = False,
    two_mode: bool = False,
    n_modes: int = 2,
    score_subset: int = 0,
    sample_mode: str = "roll",
    adapt_iterations: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-budget single-mode RANSAC per pair lane, with the exact refit.

    Args:
      p_all, q_all: [B, M, 3] correspondence points; valid: [B, M] bool.
      sample_bits: [B, n_chunks, m_s] int64 of uint32 values (JAX draws them
        as ``jax.random.bits(split(key, n_chunks)[i], (m_s,))`` with
        m_s = ``sample_row_count(M, batch_size)``); drawn from
        ``generator`` when None.

    Both clouds are shifted to the valid-correspondence centroid before the
    hypothesis work (the precondition of ``approx_score``) and the winner is
    un-shifted at return.

    Returns (T [B, 4, 4], count [B] int32).
    """
    if two_mode or n_modes > 2:
        raise NotImplementedError("ransac_pair_step: two_mode / n_modes > 2 are not ported")
    if score_subset > 0:
        raise NotImplementedError("ransac_pair_step: score_subset > 0 is not ported")
    if adapt_iterations > iterations:
        raise NotImplementedError("ransac_pair_step: the adaptive budget is not ported")
    if sample_mode != "roll":
        raise NotImplementedError("ransac_pair_step: only sample_mode='roll' is ported")

    b, m = valid.shape
    thresh_sq = f32_square(dist_thresh)
    rank_to_idx = compaction_permutation(valid)
    n_valid = torch.sum(valid, dim=-1)
    w = valid.to(torch.float32)[..., None]
    denom = torch.clamp_min(torch.sum(w, dim=-2), 1.0)
    c0 = torch.sum((p_all + q_all) * 0.5 * w, dim=-2) / denom  # [B, 3]
    p_all = torch.where(valid[..., None], p_all - c0[:, None, :], 0.0)
    q_all = torch.where(valid[..., None], q_all - c0[:, None, :], 0.0)
    n_chunks = max(1, iterations // batch_size)
    pq = torch.cat([p_all, q_all], dim=-1)
    F, c = corres_features(p_all, q_all)

    m_s = sample_row_count(m, batch_size)
    if sample_bits is None:
        sample_bits = draw_sample_bits(b, n_chunks, m_s, generator)
    if tuple(sample_bits.shape) != (b, n_chunks, m_s):
        raise ValueError(f"sample_bits must be [{b}, {n_chunks}, {m_s}], "
                         f"got {tuple(sample_bits.shape)}")
    sample_bits = sample_bits.to(device=valid.device, dtype=torch.int64)

    best_T = torch.eye(4, dtype=torch.float32, device=valid.device).repeat(b, 1, 1)
    best_count = torch.full((b,), -1, dtype=torch.int32, device=valid.device)
    for ch in range(n_chunks):
        ga, gb, gc = rolled_sample_gathers(
            sample_bits[:, ch], pq, n_valid, batch_size, rank_to_idx=rank_to_idx
        )
        R, t, counts = fit_score_gathers(
            ga, gb, gc, F, c, valid, thresh_sq,
            edge_length_ratio=edge_length_ratio, approx_score=approx_score,
        )
        k = torch.argmax(counts, dim=-1)
        cand = torch.gather(counts, -1, k[:, None])[:, 0]
        better = cand > best_count
        best_T = torch.where(better[:, None, None], winner_T(R, t, k), best_T)
        best_count = torch.where(better, cand, best_count)

    T, count = refit_inliers(best_T, torch.clamp_min(best_count, 0), p_all, q_all, valid,
                             thresh_sq)
    # T_world = Shift(c0) . T_centered . Shift(-c0).
    T = T.clone()
    T[:, :3, 3] = T[:, :3, 3] + c0 - torch.einsum("bij,bj->bi", T[:, :3, :3], c0)
    return T, count
