"""Fused registration step over a batch of pairs (port of tpu3dm/registration/fused.py).

``fused_register_step`` registers B preprocessed pairs at once: FPFH
correspondences -> fixed-budget RANSAC with the exact Horn refit (score
kernel csrc/ransac_score.cu) -> point-to-plane ICP.  It is the JAX step with
the pair dimension written out instead of ``vmap``.  The correspondences
are mutual (kernel csrc/lane_mutual.cu) or, with ``mutual_filter=False``,
the forward 33-D NN (``t3t_lane_nn_wide``, csrc/lane_nn.cu); every 3-D
search (ICP, rescue and escalation verification) is ``t3t_lane_nn_smalld``
(csrc/lane_nn.cu).  ``nn_impl`` picks the arithmetic of those searches
(``NN_ROUTES``), as JAX's names pick its XLA and Pallas formulations.

``escalated_register_step`` is the stream's heavy retry of hard pairs:
N-mode RANSAC with the adaptive budget, a lattice of screw-power probes
between its modes, and an election on verified fine-threshold counts
(``verify_elect_probes``).

With ``rescue_restarts`` R > 0 the RANSAC stage is the batched alias rescue:
R N-mode RANSAC restarts, a pose dedup, annealed point-to-plane verification
of every candidate, and an election on the verified fine-threshold count
(RESCUE_TIE_RATIO / RESCUE_OVERRIDE_MARGIN, also the rule of registration/large.py).

Every float sum over a pair's rows is ``ops.rowsum.ordered_sum`` (the
ordered-row-sum kernel csrc/row_sums.cu on CUDA) or, for the Gauss-Newton
normal equations, ``ops.rowsum.p2pl_sums`` (csrc/p2pl_sums.cu, the same
order over rows it never writes), and the small 3x3 / 4x4
products are elementwise sums in a fixed order, so a pair's result has the
same bits whatever the number of pairs in its call (JAX's serve contract:
a request's result does not depend on its micro-batch).

``fused_register_step`` opens the span ``fused.step`` and, inside it,
``fused.correspondences``, ``fused.ransac``, ``fused.rescue`` (with the
rescue) and ``fused.icp`` (``utils/profiler.py``; recorded only while
recording is on).

The step runs in a frame shifted by the target centroid rounded to a
multiple of 64: far from the origin the point-to-plane Jacobian rows
[n, p x n] pivot about a distant origin and the 6x6 normal equations lose
fp32 precision; near the origin the rounded shift is an exact no-op.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core import se3
from tpu3dm_torch.ops.nn_lane import nn_mutual_mask_batched, nn_search_lane
from tpu3dm_torch.ops.rowsum import chain_sum, ordered_sum, p2pl_sums, small_matmul, small_matvec
from tpu3dm_torch.parallel.multipair import (
    checked_bits,
    chunk_bits_shape,
    extra_chunk_count,
    f32_cos_deg,
    f32_square,
    pick_per_lane,
    ransac_pair_step,
    rot_cos,
)
from tpu3dm_torch.utils.profiler import Profiler

# The election rule of the rescue: a candidate is near the leader when its
# RANSAC fitness is at least RESCUE_TIE_RATIO of the best; a far one is
# eligible only when its verified fitness beats the near ones' best by
# RESCUE_OVERRIDE_MARGIN.
RESCUE_TIE_RATIO = 0.85
RESCUE_OVERRIDE_MARGIN = 1.05
# The escalation's screw powers exp(t log G) of the step G between two modes.
SCREW_POWERS = (-1.0, -0.5, 0.5, 1.5, 2.0)


@dataclass(frozen=True)
class NNRoute:
    """The arithmetic an ``nn_impl`` name gives the fused step's searches.

    approx_features: the mutual search honours ``approx_features`` (a bf16
      feature cross); False: fp32 whatever it says.
    cross_bf16: the mutual search rounds its cross to bf16 (JAX's
      ``nn_mutual_vals(cross_dtype=bf16)``).
    fold_mutual: JAX's mutuality test is a carried-value fold
      (``nn_mutual_vals``, ``nn_mutual_mask_fold``) whose column minimum
      starts at 0 and is taken only below BIG, so a lane without a valid
      target has no mutual row; the argmin test passes its valid rows.
    f16_payload: the ICP and verification searches return the winner's
      target point and normal centred by ``_pn_center``, rounded to f16 and
      shifted back (JAX's ``pack_f16_pairs`` carriers); their distances stay
      the exact fp32 ones.
    The non-mutual correspondences are the fp32 forward search on every
    route.  On CUDA each search is one of the same kernels.
    """

    approx_features: bool = True
    cross_bf16: bool = False
    fold_mutual: bool = False
    f16_payload: bool = False


# JAX's names with a search of their own; every other name (values_icp,
# lane_icp, dense, ...) takes OTHER_ROUTE, as JAX's else branches do.
OTHER_ROUTE = NNRoute()
NN_ROUTES = {
    "lane": NNRoute(approx_features=False),
    "values_pk": NNRoute(f16_payload=True),
    "values_b16": NNRoute(cross_bf16=True, fold_mutual=True, f16_payload=True),
    "values": NNRoute(fold_mutual=True),
    "values_corr": NNRoute(fold_mutual=True),
    "values_fold": NNRoute(fold_mutual=True),
}


def nn_route(nn_impl: str) -> NNRoute:
    return NN_ROUTES.get(nn_impl, OTHER_ROUTE)


def _pn_center(tgt_pts: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
    """Masked target centroid [B, 3], rounded to a multiple of 64."""
    w = tgt_mask.to(torch.float32)[..., None]
    s = ordered_sum(torch.cat([tgt_pts * w, w], dim=-1), dim=-2)
    c = s[..., :3] / torch.clamp_min(s[..., 3:], 1.0)
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
    correspondences (pts, q, n [B, ..., M, 3], w [B, ..., M]): the 21 unique
    entries of J^T W J and the 6 of -J^T W r as one ``p2pl_sums`` launch,
    then the Cholesky solve; a lane with a non-finite step moves by zero."""
    sums = p2pl_sums(pts, q, n, w)
    A = [[None] * 6 for _ in range(6)]
    k = 0
    for i in range(6):
        for j in range(i + 1):
            A[i][j] = sums[..., k]
            k += 1
    trA = A[0][0] + A[1][1] + A[2][2] + A[3][3] + A[4][4] + A[5][5]
    reg = 1e-6 * trA / 6.0 + 1e-12
    for i in range(6):
        A[i][i] = A[i][i] + reg
    b = [-sums[..., 21 + i] for i in range(6)]
    xi = torch.stack(_solve6_cholesky(A, b), dim=-1)
    finite = torch.all(torch.isfinite(xi), dim=-1, keepdim=True)
    return torch.where(finite, xi, 0.0)


def correspondences(src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts, *, mutual_filter=True,
                    approx=False, route: NNRoute = OTHER_ROUTE):
    """FPFH correspondences: (q_all [B, M, 3] matched target points, valid
    [B, M]).  Mutual (``nn_mutual_mask_batched`` with ``route``'s
    arithmetic, ``approx`` where it honours it): valid = src_mask & mutual;
    otherwise the fp32 forward NN of every source row, valid = src_mask."""
    if mutual_filter:
        idx, mutual = nn_mutual_mask_batched(
            src_feat, tgt_feat, src_mask, tgt_mask, approx=approx and route.approx_features,
            cross_bf16=route.cross_bf16)
        valid = src_mask & mutual
        if route.fold_mutual:
            valid = valid & torch.any(tgt_mask, dim=-1, keepdim=True)
    else:
        _, idx = nn_search_lane(src_feat, tgt_feat, src_mask, tgt_mask)
        valid = src_mask
    q_all = torch.gather(tgt_pts, 1, idx.to(torch.int64)[..., None].expand(-1, -1, 3))
    return q_all, valid


def f16_payload_rows(rows: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """[B, ..., 6] (point, normal) rows as JAX's ``values_pk`` ICP search
    returns them: the point shifted by -center [B, 3], both rounded to f16
    (to nearest even, overflow to inf) and back, the shift added back."""
    shift = torch.cat([center, torch.zeros_like(center)], dim=-1)
    shift = shift.reshape((shift.shape[0],) + (1,) * (rows.ndim - 2) + (6,))
    return (rows - shift).to(torch.float16).to(torch.float32) + shift


def _lane_search(pts, tgt_pts, tgt_mask, rows=None, f16_center=None):
    """3-D NN of pts [B, ..., M, 3] in each lane's target: every row group of
    a lane is more query rows of that lane, one kernel launch for all.
    Returns (d2 [B, ..., M], rows[idx] [B, ..., M, 6], or None without rows);
    with ``f16_center`` [B, 3] the rows come back as ``f16_payload_rows``."""
    b = pts.shape[0]
    d2, idx = nn_search_lane(pts.reshape(b, -1, 3), tgt_pts, None, tgt_mask)
    g = None
    if rows is not None:
        w = rows.shape[-1]
        g = torch.gather(rows, 1, idx.to(torch.int64)[..., None].expand(-1, -1, w))
        g = g.reshape(pts.shape[:-1] + (w,))
        if f16_center is not None:
            g = f16_payload_rows(g, f16_center)
    return d2.reshape(pts.shape[:-1]), g


def _payload_center(tgt_pts, tgt_mask, f16_payload: bool):
    return _pn_center(tgt_pts, tgt_mask) if f16_payload else None


def icp_polish(
    T, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    icp_thresh: float, icp_iterations: int, icp_solves_per_nn: int, f16_payload: bool = False,
):
    """Fixed-iteration point-to-plane ICP from T [B, 4, 4]; each 3-D NN search
    serves ``icp_solves_per_nn`` Gauss-Newton solves (``f16_payload``: see
    ``NNRoute``).  Returns (T, rmse [B])."""
    thresh_sq = f32_square(icp_thresh)
    tgt_pn = torch.cat([tgt_pts, tgt_normals], dim=-1)
    center = _payload_center(tgt_pts, tgt_mask, f16_payload)

    def solve_step(T, pts, q, n):
        d2 = chain_sum((pts - q) ** 2)
        m = (d2 < thresh_sq) & src_mask
        xi = _p2pl_delta_planar(pts, q, n, m.to(torch.float32))
        rmse = torch.sqrt(
            ordered_sum(torch.where(m, d2, 0.0)) / torch.clamp_min(torch.sum(m, dim=-1), 1)
        )
        return small_matmul(se3.exp_se3(xi, ordered=True), T), rmse

    n_outer = max(1, -(-icp_iterations // max(1, icp_solves_per_nn)))
    rmse = None
    for _ in range(n_outer):
        pts = se3.apply(T, src_pts, ordered=True)
        _, g = _lane_search(pts, tgt_pts, tgt_mask, tgt_pn, center)
        q, n = g[..., :3], g[..., 3:]
        T, rmse = solve_step(T, pts, q, n)
        for _ in range(icp_solves_per_nn - 1):
            T, rmse = solve_step(T, se3.apply(T, src_pts, ordered=True), q, n)
    return T, rmse


def rescue_candidates(
    p_all, q_all, valid, sample_bits, extra_bits=None, *,
    dist_thresh: float, iterations: int, batch_size: int, approx_score: bool, rescue_modes: int,
    sample_mode: str = "roll", sample_rows: int = 0, adapt_iterations: int = 0,
):
    """The rescue's R two-mode RANSAC restarts, one after another so that the
    peak memory stays at one restart's hypothesis stack.

    ``sample_bits`` [B, R, n_chunks, *chunk] and ``extra_bits`` [B, R,
    max_extra, *chunk] (or None without the adaptive budget): restart r's
    bits (JAX draws them along ``split(key, R)[r]``).  Returns (cands
    [B, R * n, 4, 4], counts [B, R * n] >= 0), restart-major, n =
    ``rescue_modes``.
    """
    Ts, cs = [], []
    for r in range(sample_bits.shape[1]):
        T, c = ransac_pair_step(
            p_all, q_all, valid, sample_bits[:, r],
            dist_thresh=dist_thresh, iterations=iterations, batch_size=batch_size,
            approx_score=approx_score, two_mode=True, n_modes=rescue_modes,
            sample_mode=sample_mode, sample_rows=sample_rows, adapt_iterations=adapt_iterations,
            extra_bits=None if extra_bits is None else extra_bits[:, r],
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
        Tk, ak = pick_per_lane(cands, k), pick_per_lane(aw, k)
        keepT.append(Tk)
        keepc.append(torch.clamp_min(ak, 0.0).to(torch.int32))
        rot_near = rot_cos(Tk[:, None], cands) >= cos_thr
        tdiff = chain_sum((cands[..., :3, 3] - Tk[:, None, :3, 3]) ** 2)
        same_basin = rot_near & (tdiff <= t_dup_sq)
        weak_slide = rot_near & (aw < RESCUE_TIE_RATIO * ak[:, None])
        aw = torch.where(same_basin | weak_slide, -1.0, aw)
    return torch.stack(keepT, 1), torch.stack(keepc, 1)


def _anneal_schedule(dist_thresh: float, icp_thresh: float, verify_iters: int) -> list[float]:
    """Squared thresholds falling geometrically from dist_thresh to
    icp_thresh over ``verify_iters`` solves, in fp32."""
    d = torch.tensor(dist_thresh, dtype=torch.float32)
    i = torch.tensor(icp_thresh, dtype=torch.float32)
    expo = torch.arange(verify_iters, dtype=torch.float32) / float(max(verify_iters - 1, 1))
    return ((d * (i / d) ** expo) ** 2).tolist()


def _grade(T, src_pts, src_mask, tgt_pts, tgt_mask, *, dist_thresh: float, icp_thresh: float):
    """One grading search of poses T [B, ..., 4, 4]: (fitness, fine-threshold
    inlier count, rmse), each [B, ...], from the exact 3-D distances."""
    sm = src_mask.reshape((src_mask.shape[0],) + (1,) * (T.ndim - 3) + src_mask.shape[1:])
    moved = se3.apply(T, src_pts.reshape(sm.shape + (3,)), ordered=True)
    d2, _ = _lane_search(moved, tgt_pts, tgt_mask)
    m = (d2 < f32_square(dist_thresh)) & sm
    n_src = torch.clamp_min(torch.sum(sm, dim=-1), 1).to(torch.float32)
    fit = torch.sum(m, dim=-1).to(torch.float32) / n_src
    nfine = torch.sum((d2 < f32_square(icp_thresh)) & sm, dim=-1).to(torch.float32)
    rmse = torch.sqrt(ordered_sum(torch.where(m, d2, 0.0))
                      / torch.clamp_min(torch.sum(m, dim=-1), 1))
    return fit, nfine, rmse


def verify_candidates(
    cands, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    dist_thresh: float, icp_thresh: float, verify_iters: int, f16_payload: bool = False,
):
    """Annealed point-to-plane ICP from every candidate pose (cands
    [B, C, 4, 4]): ``verify_iters`` solves whose inlier threshold falls
    geometrically from dist_thresh to icp_thresh, then one grading search.
    Each search is one launch over the lane's C x M moved source rows.

    Returns (T [B, C, 4, 4], fitness, fine-threshold inlier count, rmse,
    each [B, C])."""
    sm = src_mask[:, None, :]
    tgt_pn = torch.cat([tgt_pts, tgt_normals], dim=-1)
    center = _payload_center(tgt_pts, tgt_mask, f16_payload)
    T = cands
    for t2 in _anneal_schedule(dist_thresh, icp_thresh, verify_iters):
        pts = se3.apply(T, src_pts[:, None], ordered=True)
        _, g = _lane_search(pts, tgt_pts, tgt_mask, tgt_pn, center)
        q, nv = g[..., :3], g[..., 3:]
        m = (chain_sum((pts - q) ** 2) < t2) & sm
        xi = _p2pl_delta_planar(pts, q, nv, m.to(torch.float32))
        T = small_matmul(se3.exp_se3(xi, ordered=True), T)
    return (T,) + _grade(T, src_pts, src_mask, tgt_pts, tgt_mask, dist_thresh=dist_thresh,
                         icp_thresh=icp_thresh)


def _tiebreak(vfit, vrmse, src_mask, dist_thresh: float) -> torch.Tensor:
    """The election's tie-break score of verified candidates [B, C]: inliers
    at the coarse threshold, then (1 - RMSE / threshold) below one inlier."""
    n_src = torch.clamp_min(torch.sum(src_mask, dim=-1), 1).to(torch.float32)[:, None]
    rmse_frac = torch.clamp(vrmse / float(np.float32(dist_thresh)), 0.0, 1.0)
    return torch.round(vfit * n_src) + (1.0 - rmse_frac) * 0.999


def verify_elect(
    cands, ccounts, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, *,
    dist_thresh: float, icp_thresh: float, verify_iters: int, rescue_modes: int,
    f16_payload: bool = False,
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
        f16_payload=f16_payload,
    )
    coarse_score = _tiebreak(vfit, vrmse, src_mask, dist_thresh)
    support = ccounts.to(torch.float32)
    near = support >= RESCUE_TIE_RATIO * torch.amax(support, dim=-1, keepdim=True)
    vfine_near_best = torch.amax(torch.where(near, vfine, 0.0), dim=-1, keepdim=True)
    eligible = near | (vfine >= RESCUE_OVERRIDE_MARGIN * vfine_near_best)
    fine_best = torch.amax(torch.where(eligible, vfine, -1.0), dim=-1, keepdim=True)
    score = torch.where(eligible & (vfine >= fine_best), coarse_score, -1.0)
    best = torch.argmax(score, dim=-1)
    return pick_per_lane(vT, best), pick_per_lane(ccounts, best)


def _inputs(dev, floats, flags):
    """Contiguous fp32 tensors and bool tensors on ``dev``."""
    return ([torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous() for x in floats],
            [torch.as_tensor(x, dtype=torch.bool, device=dev) for x in flags])


def _unshift(T, frame_c):
    """T_world = Shift(frame_c) . T . Shift(-frame_c) for T [B, 4, 4]."""
    T = T.clone()
    T[:, :3, 3] = T[:, :3, 3] + frame_c - small_matvec(T[:, :3, :3], frame_c)
    return T


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
    score_subset: int = 0,
    rescore_top: int = 128,
    sample_mode: str = "roll",
    sample_rows: int = 0,
    adapt_iterations: int = 0,
    rescue_modes: int = 6,
    nn_impl: str = "values_pk",
    extra_bits: torch.Tensor | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register B preprocessed pairs: correspondences -> RANSAC -> ICP.

    Args:
      src_* / tgt_*: [B, M, ...] / [B, N, ...] arrays or tensors: points
        [., ., 3], FPFH features [., ., 33], masks [., .] and normals
        [., ., 3] (source normals are unused, as in JAX).
      sample_bits / extra_bits / generator: RANSAC bits, see
        ``parallel.multipair.ransac_pair_step``: [B, n_chunks, *chunk] and
        [B, max_extra, *chunk], or with ``rescue_restarts`` R > 0
        [B, R, n_chunks, *chunk] and [B, R, max_extra, *chunk] (JAX draws
        restart r's along ``split(key, R)[r]``); drawn from ``generator``
        when None.
      mutual_filter: mutual correspondences, or the forward NN of every
        source row.
      approx_score: round the score features to bf16 (the JAX bf16 score).
      approx_features: a bf16 feature cross in the mutual search, on every
        route but ``nn_impl="lane"`` (whose TPU kernel is fp32).
      rescue_restarts, verify_iters, rescue_modes: the batched alias rescue
        (``rescue_candidates``, ``verify_elect``); 0 restarts is the
        single-mode RANSAC.
      score_subset, rescore_top, sample_mode, sample_rows, adapt_iterations:
        passed to ``ransac_pair_step`` (the rescue's restarts take all but
        the two-stage score, as in JAX).
      nn_impl: the searches' arithmetic (``NN_ROUTES``; JAX's default
        "values_pk": f16 ICP payload).
      device: None means CUDA and raises without it; "cpu" runs the plain
        PyTorch versions.

    Returns (T [B, 4, 4] target <- source, ransac_fitness [B], icp_rmse [B]).
    """
    del src_normals
    with Profiler("fused.step"):
        route = nn_route(nn_impl)
        dev = resolve_device(device)
        with Profiler("fused.correspondences"):
            (src_pts, src_feat, tgt_pts, tgt_feat, tgt_normals), (src_mask, tgt_mask) = _inputs(
                dev, (src_pts, src_feat, tgt_pts, tgt_feat, tgt_normals), (src_mask, tgt_mask))

            # T_world = Shift(frame_c) . T . Shift(-frame_c) at return.
            frame_c = _pn_center(tgt_pts, tgt_mask)
            src_pts = (src_pts - frame_c[:, None, :]).contiguous()
            tgt_pts = (tgt_pts - frame_c[:, None, :]).contiguous()

            q_all, valid = correspondences(
                src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts, mutual_filter=mutual_filter,
                approx=approx_features, route=route)
            n_valid = torch.clamp_min(torch.sum(valid, dim=-1), 1)
        ransac_kw = dict(dist_thresh=dist_thresh, iterations=ransac_iterations,
                         batch_size=ransac_batch, approx_score=approx_score,
                         sample_mode=sample_mode, sample_rows=sample_rows,
                         adapt_iterations=adapt_iterations)
        if rescue_restarts > 0:
            with Profiler("fused.ransac"):
                b, m = valid.shape
                lead = (b, rescue_restarts)
                chunk = chunk_bits_shape(m, ransac_batch, sample_mode, sample_rows)
                n_chunks = max(1, ransac_iterations // ransac_batch)
                sample_bits = checked_bits("sample_bits", sample_bits,
                                           lead + (n_chunks,) + chunk, generator, dev)
                max_extra = extra_chunk_count(ransac_iterations, adapt_iterations, ransac_batch)
                if max_extra > 0:
                    extra_bits = checked_bits("extra_bits", extra_bits,
                                              lead + (max_extra,) + chunk, generator, dev)
                cands, ccounts = rescue_candidates(src_pts, q_all, valid, sample_bits,
                                                   extra_bits, rescue_modes=rescue_modes,
                                                   **ransac_kw)
            with Profiler("fused.rescue"):
                T, count = verify_elect(
                    cands, ccounts, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
                    dist_thresh=dist_thresh, icp_thresh=icp_thresh, verify_iters=verify_iters,
                    rescue_modes=rescue_modes, f16_payload=route.f16_payload,
                )
                fitness = count.to(torch.float32) / n_valid.to(torch.float32)
        else:
            with Profiler("fused.ransac"):
                T, count = ransac_pair_step(src_pts, q_all, valid, sample_bits, generator,
                                            score_subset=score_subset, rescore_top=rescore_top,
                                            extra_bits=extra_bits, **ransac_kw)
                fitness = count.to(torch.float32) / n_valid.to(torch.float32)

        with Profiler("fused.icp"):
            if icp_iterations == 0:
                rmse = torch.zeros_like(fitness)
            else:
                T, rmse = icp_polish(
                    T, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals,
                    icp_thresh=icp_thresh,
                    icp_iterations=icp_iterations,
                    icp_solves_per_nn=icp_solves_per_nn,
                    f16_payload=route.f16_payload,
                )
            T = _unshift(T, frame_c)
        return T, fitness, rmse


def verify_elect_probes(
    src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, cands, *,
    dist_thresh: float = 0.45, icp_thresh: float = 0.12, verify_iters: int = 8,
    nn_impl: str = "values_pk",
):
    """Annealed verification and election over explicit candidate poses
    (cands [B, C, 4, 4]), with no RANSAC-support eligibility: geometry alone
    decides.

    Each candidate's translation first snaps by the mean offset of the
    moved valid source rows to their nearest targets; then the annealed
    solves and the grading search of ``verify_candidates``.  The winner has
    the best fine-threshold count, then the best round(fit * n_src) + (1 -
    rmse / dist_thresh) * 0.999, and takes 6 more point-to-plane solves at
    the fine threshold.  Every search is one kernel launch over the lane's
    C x M moved rows, with the payload of ``nn_impl``'s route.

    Returns (T [B, 4, 4], fitness [B], rmse [B]) of the polished winner.
    """
    f16 = nn_route(nn_impl).f16_payload
    tgt_pn = torch.cat([tgt_pts, tgt_normals], dim=-1)
    wsrc = src_mask.to(torch.float32)[:, None, :, None]
    pts0 = se3.apply(cands, src_pts[:, None], ordered=True)
    _, g0 = _lane_search(pts0, tgt_pts, tgt_mask, tgt_pn, _payload_center(tgt_pts, tgt_mask, f16))
    snap = ordered_sum((g0[..., :3] - pts0) * wsrc, dim=-2) / torch.clamp_min(
        ordered_sum(wsrc, dim=-2), 1.0)
    T0 = cands.clone()
    T0[..., :3, 3] = T0[..., :3, 3] + snap
    vT, vfit, vfine, vrmse = verify_candidates(
        T0, src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, dist_thresh=dist_thresh,
        icp_thresh=icp_thresh, verify_iters=verify_iters, f16_payload=f16)
    tiebreak = _tiebreak(vfit, vrmse, src_mask, dist_thresh)
    fine_best = torch.amax(vfine, dim=-1, keepdim=True)
    best = torch.argmax(torch.where(vfine >= fine_best, tiebreak, -1.0), dim=-1)
    T, _ = icp_polish(pick_per_lane(vT, best), src_pts, src_mask, tgt_pts, tgt_mask,
                      tgt_normals, icp_thresh=icp_thresh, icp_iterations=6, icp_solves_per_nn=1,
                      f16_payload=f16)
    fit, _, rmse = _grade(T, src_pts, src_mask, tgt_pts, tgt_mask, dist_thresh=dist_thresh,
                          icp_thresh=icp_thresh)
    return T, fit, rmse


def screw_probes(Ts: torch.Tensor, init_T: torch.Tensor | None = None) -> torch.Tensor:
    """The escalation's candidates from modes Ts [B, n, 4, 4]: ``init_T``
    [B, 4, 4] first when given, the n modes, then for every pair i < j the
    powers exp(t log G) Ts[i] of the step G = Ts[j] inv(Ts[i]), t in
    SCREW_POWERS.  Returns [B, C, 4, 4], C = (init) + n + 5 n (n - 1) / 2."""
    n = Ts.shape[1]
    probes = ([] if init_T is None else [init_T]) + [Ts[:, i] for i in range(n)]
    for i in range(n):
        inv_i = se3.inverse(Ts[:, i])
        for j in range(i + 1, n):
            xi = se3.log_se3(small_matmul(Ts[:, j], inv_i))
            probes += [small_matmul(se3.exp_se3(t * xi, ordered=True), Ts[:, i])
                       for t in SCREW_POWERS]
    return torch.stack(probes, 1)


def escalated_register_step(
    src_pts,
    src_feat,
    src_mask,
    tgt_pts,
    tgt_feat,
    tgt_mask,
    tgt_normals,
    sample_bits: torch.Tensor | None = None,
    init_T=None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float = 0.45,
    icp_thresh: float = 0.12,
    ransac_iterations: int = 4096,
    ransac_batch: int = 4096,
    n_modes: int = 8,
    adapt_iterations: int = 16384,
    verify_iters: int = 8,
    nn_impl: str = "values_pk",
    extra_bits: torch.Tensor | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Heavy-budget registration of hard pairs (the stream's escalation).

    Mutual correspondences with a bf16 feature cross (whatever ``nn_impl``
    says); N-mode RANSAC (``n_modes`` peaks, bf16 score, every valid row
    sampled, the adaptive budget up to ``adapt_iterations``); the probes of
    ``screw_probes`` (``init_T`` [B, 4, 4], a world pose, first when given);
    the election of ``verify_elect_probes``.

    Args as ``fused_register_step``; ``sample_bits`` [B, n_chunks, M] and
    ``extra_bits`` [B, max_extra, M] are the RANSAC's (roll sampler,
    m_s = M).  Returns (T [B, 4, 4], fitness [B], rmse [B]).
    """
    dev = resolve_device(device)
    (src_pts, src_feat, tgt_pts, tgt_feat, tgt_normals), (src_mask, tgt_mask) = _inputs(
        dev, (src_pts, src_feat, tgt_pts, tgt_feat, tgt_normals), (src_mask, tgt_mask))
    frame_c = _pn_center(tgt_pts, tgt_mask)
    src_pts = (src_pts - frame_c[:, None, :]).contiguous()
    tgt_pts = (tgt_pts - frame_c[:, None, :]).contiguous()
    if init_T is not None:
        # The caller's world pose in the shifted frame.
        init_T = torch.as_tensor(init_T, dtype=torch.float32, device=dev).clone()
        init_T[:, :3, 3] = (init_T[:, :3, 3] - frame_c
                            + small_matvec(init_T[:, :3, :3], frame_c))

    q_all, valid = correspondences(src_feat, tgt_feat, src_mask, tgt_mask, tgt_pts, approx=True)
    Ts, _ = ransac_pair_step(
        src_pts, q_all, valid, sample_bits, generator, dist_thresh=dist_thresh,
        iterations=ransac_iterations, batch_size=ransac_batch, approx_score=True,
        two_mode=True, n_modes=n_modes, sample_rows=-1, adapt_iterations=adapt_iterations,
        extra_bits=extra_bits,
    )
    T, fit, rmse = verify_elect_probes(
        src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, screw_probes(Ts, init_T),
        dist_thresh=dist_thresh, icp_thresh=icp_thresh, verify_iters=verify_iters,
        nn_impl=nn_impl)
    return _unshift(T, frame_c), fit, rmse
