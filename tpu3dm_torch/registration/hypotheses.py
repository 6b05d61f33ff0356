"""Planar RANSAC hypothesis evaluation, batched (port of tpu3dm/registration/hypotheses.py).

A hypothesis chunk (sample K triples, fit K rigid transforms, checker-mask,
score) on planar component tensors: a rotation is a nested 3x3 tuple of
[..., K] tensors and a translation a 3-tuple, so every step is elementwise
over the pair and hypothesis dimensions.  The triple fit is triangle-frame
alignment (exact for congruent triangles); ``refit_inliers`` re-fits the
elected winner on all its inliers with the exact weighted Horn solve.

The score goes through ``ops.ransac_score.score_features``: on CUDA the
hand-written kernel, which never builds the [B, K, M] distance tensor.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.core import se3
from tpu3dm_torch.ops.ransac_score import corres_features, score_features
from tpu3dm_torch.ops.rowsum import chain_sum
from tpu3dm_torch.registration.kabsch import fit_rigid_horn

PlanarR = tuple[tuple[torch.Tensor, ...], ...]
PlanarT = tuple[torch.Tensor, torch.Tensor, torch.Tensor]

U32 = (1 << 32) - 1

# Static offset pairs of the roll sampler: rep r pairs (S[j], S[j+s1], S[j+s2]).
_ROLL_OFFSETS = ((1, 2), (3, 7), (11, 23), (41, 87), (5, 13), (17, 37), (29, 61), (53, 109))


def _rsqrt_safe(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp_min(x, 1e-30))


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _frame(ax, ay, az, bx, by, bz, cx, cy, cz):
    """Orthonormal triangle frame (e1, e2, e3, ok); ``ok`` is False for
    collinear or duplicate points, whose hypotheses must score -1."""
    ux, uy, uz = bx - ax, by - ay, bz - az
    vx, vy, vz = cx - ax, cy - ay, cz - az
    u2 = ux * ux + uy * uy + uz * uz
    v2 = vx * vx + vy * vy + vz * vz
    inv_u = _rsqrt_safe(u2)
    e1 = (ux * inv_u, uy * inv_u, uz * inv_u)
    wx, wy, wz = _cross(*e1, vx, vy, vz)
    w2 = wx * wx + wy * wy + wz * wz
    inv_w = _rsqrt_safe(w2)
    e3 = (wx * inv_w, wy * inv_w, wz * inv_w)
    e2 = _cross(*e3, *e1)
    ok = (u2 > 1e-20) & (w2 > 1e-8 * v2)
    return e1, e2, e3, ok


def fit3_frames(pa, pb, pc, qa, qb, qc) -> tuple[PlanarR, PlanarT, torch.Tensor]:
    """Rigid fit of point triples ([..., K, 3] each), planar: (R, t, ok)
    with q ~ R p + t; ok is False for degenerate samples."""
    P = (pa[..., 0], pa[..., 1], pa[..., 2], pb[..., 0], pb[..., 1], pb[..., 2],
         pc[..., 0], pc[..., 1], pc[..., 2])
    Q = (qa[..., 0], qa[..., 1], qa[..., 2], qb[..., 0], qb[..., 1], qb[..., 2],
         qc[..., 0], qc[..., 1], qc[..., 2])
    f1, f2, f3, ok_p = _frame(*P)
    g1, g2, g3, ok_q = _frame(*Q)
    # R = Fq Fp^T = g1 f1^T + g2 f2^T + g3 f3^T.
    R = tuple(
        tuple(g1[i] * f1[j] + g2[i] * f2[j] + g3[i] * f3[j] for j in range(3))
        for i in range(3)
    )
    third = 1.0 / 3.0
    cp = ((P[0] + P[3] + P[6]) * third, (P[1] + P[4] + P[7]) * third,
          (P[2] + P[5] + P[8]) * third)
    cq = ((Q[0] + Q[3] + Q[6]) * third, (Q[1] + Q[4] + Q[7]) * third,
          (Q[2] + Q[5] + Q[8]) * third)
    t = tuple(
        cq[i] - (R[i][0] * cp[0] + R[i][1] * cp[1] + R[i][2] * cp[2]) for i in range(3)
    )
    return R, t, ok_p & ok_q


def apply_planar(R: PlanarR, t: PlanarT, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Apply planar transforms to their own [..., K, 3] points -> 3 x [..., K]."""
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    return tuple(R[i][0] * px + R[i][1] * py + R[i][2] * pz + t[i] for i in range(3))


def hypothesis_features_planar(R: PlanarR, t: PlanarT) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, 16] hypothesis rows + [..., K] |t|^2 for the rank-15 score."""
    Rt_t = [R[0][j] * t[0] + R[1][j] * t[1] + R[2][j] * t[2] for j in range(3)]
    cols = (
        [2.0 * Rt_t[j] for j in range(3)]
        + [-2.0 * R[i][j] for i in range(3) for j in range(3)]
        + [-2.0 * t[i] for i in range(3)]
        + [torch.zeros_like(t[0])]
    )
    H = torch.stack(cols, dim=-1)
    e = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
    return H, e


def winner_T(R: PlanarR, t: PlanarT, k: torch.Tensor) -> torch.Tensor:
    """Hypothesis k[b] of each lane as a [B, 4, 4] transform."""
    def at(x):
        return torch.gather(x, -1, k[..., None])[..., 0]

    T = torch.zeros(k.shape + (4, 4), dtype=t[0].dtype, device=t[0].device)
    for i in range(3):
        for j in range(3):
            T[..., i, j] = at(R[i][j])
        T[..., i, 3] = at(t[i])
    T[..., 3, 3] = 1.0
    return T


def rot_cos_planar(T_ref: torch.Tensor, R: PlanarR) -> torch.Tensor:
    """cos(angle(T_ref.R, R_k)) = (trace(T_ref.R^T R_k) - 1) / 2 for every
    hypothesis: T_ref [B, 4, 4], R planar [B, K] -> [B, K]."""
    tr = sum(T_ref[:, i, j, None] * R[i][j] for i in range(3) for j in range(3))
    return (tr - 1.0) * 0.5


def prepare_correspondences(p_all: torch.Tensor, q_all: torch.Tensor):
    """Per-call operands of the hypothesis chunks: pq [..., M, 6] (one gather
    per sample slot) and the score features (F [..., M, 16], c [..., M])."""
    F, c = corres_features(p_all, q_all)
    return torch.cat([p_all, q_all], dim=-1), F, c


def sample_fit_score(pq, F, c, valid, triples, thresh_sq: float, *,
                     edge_length_ratio: float = 0.9, use_checkers: bool = True,
                     approx_score: bool = False, return_features: bool = False):
    """Fit + checkers + score of the sampled triples (triples [B, K, 3] int64
    rows of pq [B, M, 6]); see ``fit_score_gathers``."""
    ga, gb, gc = (
        torch.gather(pq, 1, triples[..., s, None].expand(-1, -1, pq.shape[-1])) for s in range(3)
    )
    return fit_score_gathers(ga, gb, gc, F, c, valid, thresh_sq,
                             edge_length_ratio=edge_length_ratio, use_checkers=use_checkers,
                             approx_score=approx_score, return_features=return_features)


def sample_distinct_triples(bits: torch.Tensor, n) -> torch.Tensor:
    """[..., K, 3] distinct indices in [0, n) from [..., K, 2] uint32 bits.

    ``n``: an int, or an int tensor of the leading shape (one count a lane);
    below 3 it counts as 3.  One uniform draw over n * (n - 1) * (n - 2)
    decomposed into shrinking ranges and shifted past the values already
    chosen.  JAX computes in uint32; this is the same arithmetic in int64
    with the uint32 wrap of (n - 1) * (n - 2) written out.
    """
    n = torch.clamp_min(torch.as_tensor(n, dtype=torch.int64, device=bits.device), 3)[..., None]
    a = bits[..., 0] % n
    r = bits[..., 1] % (((n - 1) * (n - 2)) & U32)
    b = r % (n - 1)
    c = r // (n - 1)
    b = b + (b >= a).to(torch.int64)
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    c = c + (c >= lo).to(torch.int64)
    c = c + (c >= hi).to(torch.int64)
    return torch.stack([a, b, c], dim=-1)


def sample_row_count(m: int, k: int, sample_rows: int = 0) -> int:
    """Rows the roll sampler gathers per chunk of k hypotheses over m rows
    (``RansacConfig.sample_rows``): 0 the default cap min(m, max(256,
    k // 16)), -1 every row (m), > 0 min(m, max(8, sample_rows))."""
    if sample_rows < 0:
        return m
    if sample_rows > 0:
        return min(m, max(8, sample_rows))
    return min(m, max(256, k // 16))


def rolled_sample_gathers(
    bits: torch.Tensor,
    pq: torch.Tensor,
    n_valid: torch.Tensor,
    k: int,
    *,
    rank_to_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hypothesis sample gathers (ga, gb, gc [B, K, 6]) from ONE row gather.

    ``bits`` [B, m_s] int64 holds uint32 random values (the JAX package draws
    them with ``jax.random.bits``): rank = bits % max(n_valid, 3) picks m_s
    valid rows S (through ``rank_to_idx``, the valid-first permutation), and
    triples are static rolls of S: rep r pairs (S[j], S[j+s1_r], S[j+s2_r]).
    """
    m_s = bits.shape[-1]
    nv = torch.clamp_min(n_valid, 3).to(torch.int64)
    ranks = torch.remainder(bits, nv[:, None])
    if rank_to_idx is not None:
        ranks = torch.gather(rank_to_idx, 1, ranks)
    S = torch.gather(pq, 1, ranks[..., None].expand(-1, -1, pq.shape[-1]))
    reps = -(-k // m_s)
    offs = _ROLL_OFFSETS
    if reps > len(offs):
        offs = tuple(offs[i] if i < len(offs) else (2 * i + 1, 4 * i + 3) for i in range(reps))
    gbs = [torch.roll(S, -offs[r][0], dims=1) for r in range(reps)]
    gcs = [torch.roll(S, -offs[r][1], dims=1) for r in range(reps)]
    if reps == 1:
        return S[:, :k], gbs[0][:, :k], gcs[0][:, :k]
    return (
        S.repeat(1, reps, 1)[:, :k],
        torch.cat(gbs, dim=1)[:, :k],
        torch.cat(gcs, dim=1)[:, :k],
    )


def fit_score_gathers(
    ga: torch.Tensor,
    gb: torch.Tensor,
    gc: torch.Tensor,
    F: torch.Tensor,
    c: torch.Tensor,
    valid: torch.Tensor,
    thresh_sq: float,
    *,
    edge_length_ratio: float = 0.9,
    use_checkers: bool = True,
    approx_score: bool = False,
    return_features: bool = False,
) -> tuple:
    """Fit + checkers + score from pre-gathered sample rows (ga/gb/gc
    [B, K, 6]); F [B, M, 16], c [B, M], valid [B, M].  ``use_checkers``
    applies the edge-length and distance checkers (Open3D's).

    ``approx_score`` rounds H and F to bf16 and scores them as bf16 (on CUDA
    the tensor-core kernel): the products of bf16 values are exact in fp32,
    so this is the JAX package's bf16-in, fp32-accumulate dot.

    Returns (R, t, counts [B, K] int32); checker failures and non-finite
    fits score -1.  With ``return_features`` also the fp32 hypothesis rows
    (H [B, K, 16], e [B, K]), for an exact rescore (``rescore_rows``).
    """
    pa, qa = ga[..., :3], ga[..., 3:]
    pb, qb = gb[..., :3], gb[..., 3:]
    pc_, qc = gc[..., :3], gc[..., 3:]
    R, t, ok = fit3_frames(pa, pb, pc_, qa, qb, qc)

    H, e = hypothesis_features_planar(R, t)
    if approx_score:
        counts = score_features(H.to(torch.bfloat16), e, F.to(torch.bfloat16), c, valid,
                                thresh_sq)
    else:
        counts = score_features(H, e, F, c, valid, thresh_sq)
    extra = (H, e) if return_features else ()

    # Degenerate / non-finite fits must never be elected.
    ok = ok & torch.isfinite(e)
    if not use_checkers:
        return (R, t, torch.where(ok, counts, -1)) + extra

    def e2(a, b):
        d = a - b
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]

    r2 = edge_length_ratio * edge_length_ratio

    def edge_ok(x, y, u, v):
        es, et = e2(x, y), e2(u, v)
        return (et > r2 * es) & (es > r2 * et)

    ok = ok & edge_ok(pa, pb, qa, qb) & edge_ok(pb, pc_, qb, qc) & edge_ok(pc_, pa, qc, qa)

    def close(pp, qq):
        mx, my, mz = apply_planar(R, t, pp)
        dx, dy, dz = mx - qq[..., 0], my - qq[..., 1], mz - qq[..., 2]
        return dx * dx + dy * dy + dz * dz < thresh_sq

    ok = ok & close(pa, qa) & close(pb, qb) & close(pc_, qc)
    return (R, t, torch.where(ok, counts, -1)) + extra


def rescore_rows(H, e, F, c, valid, thresh_sq: float) -> torch.Tensor:
    """Exact fp32 inlier counts [B, K'] of hypothesis rows (H [B, K', 16],
    e [B, K']) over every correspondence (F [B, M, 16], c, valid [B, M]):
    the second stage of two-stage scoring, fp32 whatever ``approx_score``
    says (on CUDA kernel 3's fp32 route)."""
    return score_features(H.contiguous(), e.contiguous(), F, c, valid, thresh_sq)


def count_inliers(T, p_all, q_all, valid, thresh_sq: float):
    """(inlier mask [..., M], count [...]) of transforms T [..., 4, 4] on
    their correspondences p_all, q_all [..., M, 3]."""
    d2 = chain_sum((se3.apply(T, p_all, ordered=True) - q_all) ** 2)
    inl = (d2 < thresh_sq) & valid
    return inl, torch.sum(inl, dim=-1, dtype=torch.int32)


def refit_inliers(T, count, p_all, q_all, valid, thresh_sq: float):
    """Weighted Horn re-fit of each elected transform (T [..., 4, 4], count
    [...]) on all its inliers, kept only where it does not lose inliers.
    Returns (T', count')."""
    inl, _ = count_inliers(T, p_all, q_all, valid, thresh_sq)
    T_ref = fit_rigid_horn(p_all, q_all, inl.to(torch.float32))
    _, count_ref = count_inliers(T_ref, p_all, q_all, valid, thresh_sq)
    better = count_ref >= torch.clamp_min(count, 3)
    return torch.where(better[..., None, None], T_ref, T), torch.where(better, count_ref, count)
