"""Fused registration step over a batch of pairs (port of tpu3dm/registration/fused.py).

``fused_register_step`` registers B preprocessed pairs at once: FPFH
correspondences -> fixed-budget RANSAC with the exact Horn refit (score
kernel csrc/ransac_score.cu) -> point-to-plane ICP.  It is the JAX step with
``nn_impl="lane"``, with the pair dimension written out instead of
``vmap``.  The correspondences are mutual (kernel csrc/lane_mutual.cu) or,
with ``mutual_filter=False``, the forward 33-D NN (``t3t_lane_nn_wide``,
csrc/lane_nn.cu); every 3-D search (ICP, rescue verification) is
``t3t_lane_nn_smalld`` (csrc/lane_nn.cu).

With ``rescue_restarts`` R > 0 the RANSAC stage is the batched alias rescue:
R N-mode RANSAC restarts, a pose dedup, annealed point-to-plane verification
of every candidate, and an election on the verified fine-threshold count
(RESCUE_TIE_RATIO / RESCUE_OVERRIDE_MARGIN, also the rule of registration/large.py).

The step runs in a frame shifted by the target centroid rounded to a
multiple of 64: far from the origin the point-to-plane Jacobian rows
[n, p x n] pivot about a distant origin and the 6x6 normal equations lose
fp32 precision; near the origin the rounded shift is an exact no-op.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core import se3
from tpu3dm_torch.ops.nn_lane import nn_mutual_mask_lane, nn_search_lane
from tpu3dm_torch.parallel.multipair import (
    _at,
    draw_sample_bits,
    f32_cos_deg,
    f32_square,
    ransac_pair_step,
    rot_cos,
)
from tpu3dm_torch.registration.hypotheses import sample_row_count

# The election rule of the rescue: a candidate is near the leader when its
# RANSAC fitness is at least RESCUE_TIE_RATIO of the best; a far one is
# eligible only when its verified fitness beats the near ones' best by
# RESCUE_OVERRIDE_MARGIN.
RESCUE_TIE_RATIO = 0.85
RESCUE_OVERRIDE_MARGIN = 1.05


def _pn_center(tgt_pts: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
    """Masked target centroid [B, 3], rounded to a multiple of 64."""
    w = tgt_mask.to(torch.float32)[..., None]
    c = torch.sum(tgt_pts * w, dim=-2) / torch.clamp_min(torch.sum(w, dim=-2), 1.0)
    return torch.round(c / 64.0) * 64.0


def _solve6_cholesky(A, b):
    """Solve the symmetric 6x6 systems (nested lists of [B] tensors, lower
    triangle used) with an unrolled Cholesky."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp_min(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = []
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _p2pl_delta_planar(pts, q, n, w):
    """Point-to-plane Gauss-Newton step xi [B, 6] from weighted
    correspondences (pts, q, n [B, M, 3], w [B, M]): the 21 unique entries of
    J^T W J and the 6 of -J^T W r as masked reductions, then the Cholesky
    solve; a lane with a non-finite step moves by zero."""
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    J = (nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx)
    r = (px - q[..., 0]) * nx + (py - q[..., 1]) * ny + (pz - q[..., 2]) * nz
    A = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            A[i][j] = torch.sum(w * J[i] * J[j], dim=-1)
    trA = A[0][0] + A[1][1] + A[2][2] + A[3][3] + A[4][4] + A[5][5]
    reg = 1e-6 * trA / 6.0 + 1e-12
    for i in range(6):
        A[i][i] = A[i][i] + reg
    b = [-torch.sum(w * J[i] * r, dim=-1) for i in range(6)]
    xi = torch.stack(_solve6_cholesky(A, b), dim=-1)
    finite = torch.all(torch.isfinite(xi), dim=-1, keepdim=True)
    return torch.where(finite, xi, 0.0)


def correspondences(src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts, *, mutual_filter=True):
    """FPFH correspondences: (q_all [B, M, 3] matched target points, valid
    [B, M]).  Mutual: valid = src_mask & mutual; otherwise the forward NN of
    every source row, valid = src_mask."""
    if mutual_filter:
        idx, mutual = nn_mutual_mask_lane(src_feat, tgt_feat, src_mask, tgt_mask)
        valid = src_mask & mutual
    else:
        _, idx = nn_search_lane(src_feat, tgt_feat, src_mask, tgt_mask)
        valid = src_mask
    q_all = torch.gather(tgt_pts, 1, idx.to(torch.int64)[..., None].expand(-1, -1, 3))
    return q_all, valid


def _lane_search(pts, tgt_pts, tgt_mask, rows=None):
    """3-D NN of pts [B, ..., M, 3] in each lane's target: every row group of
    a lane is more query rows of that lane, one kernel launch for all.
    Returns (d2 [B, ..., M], rows[idx] [B, ..., M, w], or None without rows)."""
    b = pts.shape[0]
    d2, idx = nn_search_lane(pts.reshape(b, -1, 3), tgt_pts, None, tgt_mask)
    g = None
    if rows is not None:
        w = rows.shape[-1]
        g = torch.gather(rows, 1, idx.to(torch.int64)[..., None].expand(-1, -1, w))
        g = g.reshape(pts.shape[:-1] + (w,))
    return d2.reshape(pts.shape[:-1]), g


def icp_polish(
    T, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    icp_thresh: float, icp_iterations: int, icp_solves_per_nn: int,
):
    """Fixed-iteration point-to-plane ICP from T [B, 4, 4]; each 3-D NN search
    serves ``icp_solves_per_nn`` Gauss-Newton solves.  Returns (T, rmse [B])."""
    thresh_sq = f32_square(icp_thresh)
    tgt_pn = torch.cat([tgt_pts, tgt_normals], dim=-1)

    def solve_step(T, pts, q, n):
        d2 = torch.sum((pts - q) ** 2, dim=-1)
        m = (d2 < thresh_sq) & src_mask
        xi = _p2pl_delta_planar(pts, q, n, m.to(torch.float32))
        rmse = torch.sqrt(
            torch.sum(torch.where(m, d2, 0.0), dim=-1)
            / torch.clamp_min(torch.sum(m, dim=-1), 1)
        )
        return se3.exp_se3(xi) @ T, rmse

    n_outer = max(1, -(-icp_iterations // max(1, icp_solves_per_nn)))
    rmse = None
    for _ in range(n_outer):
        pts = se3.apply(T, src_pts)
        _, g = _lane_search(pts, tgt_pts, tgt_mask, tgt_pn)
        q, n = g[..., :3], g[..., 3:]
        T, rmse = solve_step(T, pts, q, n)
        for _ in range(icp_solves_per_nn - 1):
            T, rmse = solve_step(T, se3.apply(T, src_pts), q, n)
    return T, rmse


def rescue_candidates(
    p_all, q_all, valid, sample_bits, *,
    dist_thresh: float, iterations: int, batch_size: int, approx_score: bool, rescue_modes: int,
):
    """The rescue's R two-mode RANSAC restarts, one after another so that the
    peak memory stays at one restart's hypothesis stack.

    ``sample_bits`` [B, R, n_chunks, m_s]: restart r's bits (JAX draws them
    along ``split(key, R)[r]``).  Returns (cands [B, R * n, 4, 4], counts
    [B, R * n] >= 0), restart-major, n = ``rescue_modes``.
    """
    Ts, cs = [], []
    for r in range(sample_bits.shape[1]):
        T, c = ransac_pair_step(
            p_all, q_all, valid, sample_bits[:, r],
            dist_thresh=dist_thresh, iterations=iterations, batch_size=batch_size,
            approx_score=approx_score, two_mode=True, n_modes=rescue_modes,
        )
        Ts.append(T)
        cs.append(c)
    return torch.cat(Ts, 1), torch.clamp_min(torch.cat(cs, 1), 0)


def _dedup(cands, ccounts, *, dist_thresh: float, n_keep: int):
    """Greedy pose dedup to n_keep candidates by RANSAC support: a candidate
    near a taken one in rotation (15 deg) AND translation (3 x dist_thresh)
    is a duplicate, and a rotation-near one under RESCUE_TIE_RATIO of the
    taken one's support is a weak translation slide; both are dropped."""
    cos_thr = f32_cos_deg(15.0)
    t_dup_sq = f32_square(np.float32(3.0) * np.float32(dist_thresh))
    keepT, keepc = [], []
    aw = ccounts.to(torch.float32)
    for _ in range(n_keep):
        k = torch.argmax(aw, dim=-1)
        Tk, ak = _at(cands, k), _at(aw, k)
        keepT.append(Tk)
        keepc.append(torch.clamp_min(ak, 0.0).to(torch.int32))
        rot_near = rot_cos(Tk[:, None], cands) >= cos_thr
        tdiff = torch.sum((cands[..., :3, 3] - Tk[:, None, :3, 3]) ** 2, dim=-1)
        same_basin = rot_near & (tdiff <= t_dup_sq)
        weak_slide = rot_near & (aw < RESCUE_TIE_RATIO * ak[:, None])
        aw = torch.where(same_basin | weak_slide, -1.0, aw)
    return torch.stack(keepT, 1), torch.stack(keepc, 1)


def verify_candidates(
    cands, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    dist_thresh: float, icp_thresh: float, verify_iters: int,
):
    """Annealed point-to-plane ICP from every candidate pose (cands
    [B, C, 4, 4]): ``verify_iters`` solves whose inlier threshold falls
    geometrically from dist_thresh to icp_thresh, then one grading search.
    Each search is one launch over the lane's C x M moved source rows.

    Returns (T [B, C, 4, 4], fitness, fine-threshold inlier count, rmse,
    each [B, C])."""
    n_src = torch.clamp_min(torch.sum(src_mask, dim=-1), 1).to(torch.float32)[:, None]
    sm = src_mask[:, None, :]
    tgt_pn = torch.cat([tgt_pts, tgt_normals], dim=-1)
    # Geometric schedule from the coarse to the fine threshold, squared, in fp32.
    d, i = torch.tensor(dist_thresh, dtype=torch.float32), torch.tensor(icp_thresh, dtype=torch.float32)
    expo = torch.arange(verify_iters, dtype=torch.float32) / float(max(verify_iters - 1, 1))
    anneal = ((d * (i / d) ** expo) ** 2).tolist()
    T = cands
    for t2 in anneal:
        pts = se3.apply(T, src_pts[:, None])
        _, g = _lane_search(pts, tgt_pts, tgt_mask, tgt_pn)
        q, nv = g[..., :3], g[..., 3:]
        m = (torch.sum((pts - q) ** 2, dim=-1) < t2) & sm
        T = se3.exp_se3(_p2pl_delta_planar(pts, q, nv, m.to(torch.float32))) @ T
    d2, _ = _lane_search(se3.apply(T, src_pts[:, None]), tgt_pts, tgt_mask)
    m = (d2 < f32_square(dist_thresh)) & sm
    fit = torch.sum(m, dim=-1).to(torch.float32) / n_src
    nfine = torch.sum((d2 < f32_square(icp_thresh)) & sm, dim=-1).to(torch.float32)
    rmse = torch.sqrt(torch.sum(torch.where(m, d2, 0.0), dim=-1)
                      / torch.clamp_min(torch.sum(m, dim=-1), 1))
    return T, fit, nfine, rmse


def verify_elect(
    cands, ccounts, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    dist_thresh: float, icp_thresh: float, verify_iters: int, rescue_modes: int,
):
    """Dedup (with several restarts and more than two modes), verification
    and election of the rescue's candidates (cands [B, C, 4, 4], ccounts
    [B, C] RANSAC supports).

    The election: a candidate is near when its support is at least
    RESCUE_TIE_RATIO of the lane's best; a far one is eligible only when its
    verified fine count reaches RESCUE_OVERRIDE_MARGIN x the near ones'
    best.  Among eligibles the fine count decides, then (inliers, -rmse) at
    the coarse threshold.  Returns (T [B, 4, 4], support [B] int32)."""
    if cands.shape[1] > rescue_modes > 2:  # several restarts
        cands, ccounts = _dedup(cands, ccounts, dist_thresh=dist_thresh,
                                n_keep=min(cands.shape[1], rescue_modes + 4))
    vT, vfit, vfine, vrmse = verify_candidates(
        cands, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
        dist_thresh=dist_thresh, icp_thresh=icp_thresh, verify_iters=verify_iters,
    )
    n_src = torch.clamp_min(torch.sum(src_mask, dim=-1), 1).to(torch.float32)[:, None]
    rmse_frac = torch.clamp(vrmse / float(np.float32(dist_thresh)), 0.0, 1.0)
    coarse_score = torch.round(vfit * n_src) + (1.0 - rmse_frac) * 0.999
    support = ccounts.to(torch.float32)
    near = support >= RESCUE_TIE_RATIO * torch.amax(support, dim=-1, keepdim=True)
    vfine_near_best = torch.amax(torch.where(near, vfine, 0.0), dim=-1, keepdim=True)
    eligible = near | (vfine >= RESCUE_OVERRIDE_MARGIN * vfine_near_best)
    fine_best = torch.amax(torch.where(eligible, vfine, -1.0), dim=-1, keepdim=True)
    score = torch.where(eligible & (vfine >= fine_best), coarse_score, -1.0)
    best = torch.argmax(score, dim=-1)
    return _at(vT, best), _at(ccounts, best)


def fused_register_step(
    src_pts,
    src_feat,
    src_mask,
    src_normals,
    tgt_pts,
    tgt_feat,
    tgt_mask,
    tgt_normals,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float = 0.45,
    icp_thresh: float = 0.12,
    ransac_iterations: int = 4096,
    ransac_batch: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 1,
    mutual_filter: bool = True,
    approx_score: bool = False,
    approx_features: bool = False,
    rescue_restarts: int = 0,
    verify_iters: int = 8,
    rescue_modes: int = 6,
    nn_impl: str = "lane",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register B preprocessed pairs: correspondences -> RANSAC -> ICP.

    Args:
      src_* / tgt_*: [B, M, ...] / [B, N, ...] arrays or tensors: points
        [., ., 3], FPFH features [., ., 33], masks [., .] and normals
        [., ., 3] (source normals are unused, as in JAX).
      sample_bits / generator: RANSAC sample bits, see
        ``parallel.multipair.ransac_pair_step``: [B, n_chunks, m_s], or
        [B, R, n_chunks, m_s] with ``rescue_restarts`` R > 0 (JAX draws
        restart r's along ``split(key, R)[r]``).
      mutual_filter: mutual correspondences, or the forward NN of every
        source row.
      approx_score: round the score features to bf16 (the JAX bf16 score).
      approx_features: accepted and ignored; the feature searches are fp32,
        as the TPU lane kernels' are.
      rescue_restarts, verify_iters, rescue_modes: the batched alias rescue
        (``rescue_candidates``, ``verify_elect``); 0 restarts is the
        single-mode RANSAC.
      device: None means CUDA and raises without it; "cpu" runs the plain
        PyTorch versions.

    Only ``nn_impl="lane"`` is ported; other values raise
    NotImplementedError.

    Returns (T [B, 4, 4] target <- source, ransac_fitness [B], icp_rmse [B]).
    """
    del src_normals, approx_features
    if nn_impl != "lane":
        raise NotImplementedError(f"fused_register_step: nn_impl={nn_impl!r} is not ported")
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def flag(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev)

    src_pts, src_feat, src_mask = f32(src_pts), f32(src_feat).contiguous(), flag(src_mask)
    tgt_pts, tgt_feat, tgt_mask = f32(tgt_pts), f32(tgt_feat).contiguous(), flag(tgt_mask)
    tgt_normals = f32(tgt_normals)

    # T_world = Shift(frame_c) . T . Shift(-frame_c) at return.
    frame_c = _pn_center(tgt_pts, tgt_mask)
    src_pts = (src_pts - frame_c[:, None, :]).contiguous()
    tgt_pts = (tgt_pts - frame_c[:, None, :]).contiguous()

    q_all, valid = correspondences(src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts,
                                   mutual_filter=mutual_filter)
    n_valid = torch.clamp_min(torch.sum(valid, dim=-1), 1)
    ransac_kw = dict(dist_thresh=dist_thresh, iterations=ransac_iterations,
                     batch_size=ransac_batch, approx_score=approx_score)
    if rescue_restarts > 0:
        b, m = valid.shape
        n_chunks = max(1, ransac_iterations // ransac_batch)
        m_s = sample_row_count(m, ransac_batch)
        if sample_bits is None:
            sample_bits = draw_sample_bits(b, rescue_restarts * n_chunks, m_s, generator)
            sample_bits = sample_bits.reshape(b, rescue_restarts, n_chunks, m_s)
        if tuple(sample_bits.shape) != (b, rescue_restarts, n_chunks, m_s):
            raise ValueError(f"sample_bits must be [{b}, {rescue_restarts}, {n_chunks}, {m_s}], "
                             f"got {tuple(sample_bits.shape)}")
        cands, ccounts = rescue_candidates(src_pts, q_all, valid, sample_bits,
                                           rescue_modes=rescue_modes, **ransac_kw)
        T, count = verify_elect(
            cands, ccounts, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
            dist_thresh=dist_thresh, icp_thresh=icp_thresh, verify_iters=verify_iters,
            rescue_modes=rescue_modes,
        )
    else:
        T, count = ransac_pair_step(src_pts, q_all, valid, sample_bits, generator, **ransac_kw)
    fitness = count.to(torch.float32) / n_valid.to(torch.float32)

    if icp_iterations == 0:
        rmse = torch.zeros_like(fitness)
    else:
        T, rmse = icp_polish(
            T, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
            icp_thresh=icp_thresh,
            icp_iterations=icp_iterations,
            icp_solves_per_nn=icp_solves_per_nn,
        )
    T = T.clone()
    T[:, :3, 3] = T[:, :3, 3] + frame_c - torch.einsum("bij,bj->bi", T[:, :3, :3], frame_c)
    return T, fitness, rmse
