"""Fixed-budget RANSAC over a batch of pairs (port of tpu3dm/parallel/multipair.py).

``ransac_pair_step`` is the JAX single-pair step with the pair dimension
written out: every tensor carries a leading [B] lane axis, the hypothesis
chunks run as a Python loop, and the sample bits come from the caller or a
``torch.Generator`` in place of a ``jax.random`` key.  It runs single-mode,
two-mode (the leader and the best rotation-far hypothesis) and N-mode
(``n_modes`` rotation-separated support peaks), as the batched alias rescue
of registration/fused.py needs.
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
    rot_cos_planar,
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


def f32_cos_deg(deg: float) -> float:
    """``jnp.cos(jnp.deg2rad(jnp.float32(deg)))`` as a Python float."""
    return float(np.cos(np.deg2rad(np.float32(deg))))


def rot_cos(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """cos of the rotation angle between Ta and Tb ([..., 4, 4] each):
    (trace(Ra^T Rb) - 1) / 2."""
    return (torch.sum(Ta[..., :3, :3] * Tb[..., :3, :3], dim=(-2, -1)) - 1.0) * 0.5


def _at(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[b, k[b]] for x [B, K, ...] and k [B]."""
    return x[torch.arange(x.shape[0], device=x.device), k]


def _peaks(R, t, counts, n_modes: int, cos_thr: float):
    """The n_modes best rotation-separated hypotheses of a chunk: iterative
    argmax, masking every hypothesis rotation-near the one taken.  Returns
    (Ts [B, n, 4, 4], counts [B, n])."""
    Ts, cs, cw = [], [], counts
    for _ in range(n_modes):
        k = torch.argmax(cw, dim=-1)
        Tk = winner_T(R, t, k)
        Ts.append(Tk)
        cs.append(_at(cw, k))
        cw = torch.where(rot_cos_planar(Tk, R) >= cos_thr, -1, cw)
    return torch.stack(Ts, 1), torch.stack(cs, 1)


def _reselect(allT, allc, n_modes: int, cos_thr: float):
    """Greedy re-selection of n_modes rotation-separated modes from carried
    and new candidates (allT [B, C, 4, 4], allc [B, C]); a rotation
    duplicate of a taken mode counts -1."""
    outT, outc, aw = [], [], allc
    for _ in range(n_modes):
        k = torch.argmax(aw, dim=-1)
        Tk = _at(allT, k)
        outT.append(Tk)
        outc.append(_at(aw, k))
        aw = torch.where(rot_cos(Tk[:, None], allT) >= cos_thr, -1, aw)
    return torch.stack(outT, 1), torch.stack(outc, 1)


def _where_T(cond: torch.Tensor, Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[:, None, None], Ta, Tb)


def _merge(T1, c1, T2, c2, Tc, cc, cos_thr: float):
    """Fold candidate (Tc, cc) into the two mode slots (branchless, per
    lane): a better candidate takes slot 1 whether or not it is
    rotation-near the leader; nearness to the leader only gates slot 2."""
    near1 = rot_cos(T1, Tc) >= cos_thr
    up = cc > c1
    far_T2 = _where_T(up, T1, _where_T(cc > c2, Tc, T2))
    far_c2 = torch.where(up, c1, torch.maximum(cc, c2))
    return (_where_T(up, Tc, T1), torch.maximum(cc, c1),
            _where_T(near1, T2, far_T2), torch.where(near1, c2, far_c2))


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
    mode_angle_deg: float = 15.0,
    n_modes: int = 2,
    score_subset: int = 0,
    sample_mode: str = "roll",
    adapt_iterations: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-budget RANSAC per pair lane, with the exact refit.

    Args:
      p_all, q_all: [B, M, 3] correspondence points; valid: [B, M] bool.
      sample_bits: [B, n_chunks, m_s] int64 of uint32 values (JAX draws them
        as ``jax.random.bits(split(key, n_chunks)[i], (m_s,))`` with
        m_s = ``sample_row_count(M, batch_size)``); drawn from
        ``generator`` when None.
      two_mode: also track the best hypothesis whose rotation is more than
        ``mode_angle_deg`` from the leader (``n_modes == 2``), or the
        ``n_modes`` best rotation-separated support peaks (``n_modes > 2``).

    Both clouds are shifted to the valid-correspondence centroid before the
    hypothesis work (the precondition of ``approx_score``); every returned
    mode is re-fitted on its inliers and un-shifted.

    Returns (T [B, 4, 4], count [B] int32), or with ``two_mode``
    (Ts [B, n_modes, 4, 4], counts [B, n_modes]), the leader first.
    """
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

    def fit_chunk(ch):
        ga, gb, gc = rolled_sample_gathers(
            sample_bits[:, ch], pq, n_valid, batch_size, rank_to_idx=rank_to_idx
        )
        return fit_score_gathers(
            ga, gb, gc, F, c, valid, thresh_sq,
            edge_length_ratio=edge_length_ratio, approx_score=approx_score,
        )

    def finalize(T, count):
        """Refit on the inliers and un-shift: T [B, 4, 4], or [B, n, 4, 4]
        with the correspondences broadcast over the n modes (one call for
        all modes)."""
        lead = T.shape[:-2]
        one = (b,) + (1,) * (len(lead) - 1)

        def per_mode(x):
            return x.reshape(one + x.shape[1:]).expand(lead + x.shape[1:])

        T, count = refit_inliers(T, torch.clamp_min(count, 0), per_mode(p_all), per_mode(q_all),
                                 per_mode(valid), thresh_sq)
        # T_world = Shift(c0) . T_centered . Shift(-c0).
        c = c0.reshape(one + (3,))
        T = T.clone()
        T[..., :3, 3] = T[..., :3, 3] + c - torch.einsum("...ij,...j->...i", T[..., :3, :3], c)
        return T, count

    eye = torch.eye(4, dtype=torch.float32, device=valid.device).repeat(b, 1, 1)
    none = torch.full((b,), -1, dtype=torch.int32, device=valid.device)
    if not two_mode:
        best_T, best_count = eye, none
        for ch in range(n_chunks):
            R, t, counts = fit_chunk(ch)
            k = torch.argmax(counts, dim=-1)
            cand = _at(counts, k)
            better = cand > best_count
            best_T = _where_T(better, winner_T(R, t, k), best_T)
            best_count = torch.where(better, cand, best_count)
        return finalize(best_T, best_count)

    cos_thr = f32_cos_deg(mode_angle_deg)
    if n_modes > 2:
        Ts = eye[:, None].repeat(1, n_modes, 1, 1)
        cs = none[:, None].repeat(1, n_modes)
        for ch in range(n_chunks):
            newT, newc = _peaks(*fit_chunk(ch), n_modes, cos_thr)
            Ts, cs = _reselect(torch.cat([Ts, newT], 1), torch.cat([cs, newc], 1),
                               n_modes, cos_thr)
    else:
        T1, c1, T2, c2 = eye, none, eye, none
        for ch in range(n_chunks):
            R, t, counts = fit_chunk(ch)
            ka = torch.argmax(counts, dim=-1)
            Ta, ca = winner_T(R, t, ka), _at(counts, ka)
            far = torch.where(rot_cos_planar(Ta, R) < cos_thr, counts, -1)
            kb = torch.argmax(far, dim=-1)
            Tb, cb = winner_T(R, t, kb), _at(far, kb)
            T1, c1, T2, c2 = _merge(T1, c1, T2, c2, Ta, ca, cos_thr)
            T1, c1, T2, c2 = _merge(T1, c1, T2, c2, Tb, cb, cos_thr)
        Ts, cs = torch.stack([T1, T2], 1), torch.stack([c1, c2], 1)
    return finalize(Ts, cs)
