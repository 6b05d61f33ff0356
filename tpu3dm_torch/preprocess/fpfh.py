"""33-D FPFH features (port of tpu3dm/preprocess/fpfh.py).

Two formulations, as in JAX:

  - ``fpfh_from_knn`` / ``compute_fpfh_capped`` (the default,
    ``fpfh_max_nn`` > 0): Open3D semantics from hybrid-search slots (the
    max_nn nearest within the radius): the PCL source/target swap rule per
    pair, bin order (theta | alpha | phi), neighbour weighting by 1 /
    squared distance, and each 11-bin sub-histogram of the neighbour sum
    normalised to 100 before the self-SPFH is added.
  - ``compute_fpfh`` (``fpfh_max_nn=0``): every neighbour in the radius, in
    Rusu's classic form (Darboux frame on the query's normal, alpha | phi |
    theta bins, 1 / |d| weights, 1 / k normalisation), both passes over
    target blocks of ``chunk`` rows so no [N, N, 33] temporary forms.

Every function takes one cloud ([N, 3]) or a batch ([B, N, 3]).  No Pallas
kernel is on either route in JAX (XLA ops and ``lax.top_k``), so the plain
PyTorch here is the port.
"""

from __future__ import annotations

import math

import torch

from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud
from tpu3dm_torch.ops.topk import gather_rows, nn_topk

FPFH_DIM = 33
_NBINS = 11
_EPS = 1e-12


def _pair_features(qp, qn, pj, nj, dp, dist, nb):
    """Open3D/PCL pair features with the source/target swap rule.

    qp, qn: [..., N, 3] query points / normals; pj, nj: [..., N, K, 3]
    neighbours; dp = pj - qp[..., None, :]; dist = |dp|; nb: [..., N, K]
    neighbour validity.  Returns (theta, alpha, phi), each [..., N, K].
    """
    del qp, nb
    safe_dist = torch.clamp_min(dist, _EPS)
    ni = qn[..., None, :].expand(pj.shape)
    angle1 = torch.sum(ni * dp, dim=-1) / safe_dist
    angle2 = torch.sum(nj * dp, dim=-1) / safe_dist
    # acos(|a1|) > acos(|a2|)  <=>  |a1| < |a2|  -> swap
    swap = torch.abs(angle1) < torch.abs(angle2)
    n1 = torch.where(swap[..., None], nj, ni)
    n2 = torch.where(swap[..., None], ni, nj)
    dpe = torch.where(swap[..., None], -dp, dp)
    phi = torch.where(swap, -angle2, angle1)

    v = torch.linalg.cross(dpe, n1, dim=-1)
    v_norm = torch.linalg.vector_norm(v, dim=-1)
    degenerate = v_norm < _EPS
    vh = v / torch.clamp_min(v_norm, _EPS)[..., None]
    w = torch.linalg.cross(n1, vh, dim=-1)
    alpha = torch.sum(vh * n2, dim=-1)
    theta = torch.atan2(torch.sum(w * n2, dim=-1), torch.sum(n1 * n2, dim=-1))
    # Degenerate pairs (dp parallel to u): all-zero features, as Open3D.
    zero = torch.zeros_like(phi)
    theta = torch.where(degenerate, zero, theta)
    alpha = torch.where(degenerate, zero, alpha)
    phi = torch.where(degenerate, zero, phi)
    return theta, alpha, phi


def fpfh_from_knn(
    pc: PointCloud, d2: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor
) -> PointCloud:
    """Open3D-exact FPFH of a cloud ([N, 3] points), or of a batch of clouds
    ([B, N, 3]), from hybrid-search slots [..., N, K]."""
    pts = torch.where(pc.mask[..., None], pc.points, PAD_SENTINEL)
    nrm = pc.normals
    nb = valid & (d2 > _EPS)  # true neighbours: in radius, not self

    pj = gather_rows(pts, idx)
    njn = gather_rows(nrm, idx)
    dp = pj - pts[..., None, :]
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    theta, alpha, phi = _pair_features(pts, nrm, pj, njn, dp, dist, nb)

    nbf = nb.to(torch.float32)
    cnt = torch.sum(nbf, dim=-1)
    hist_incr = torch.where(cnt > 0, 100.0 / torch.clamp_min(cnt, 1.0), 0.0)
    iota = torch.arange(_NBINS, device=pts.device)

    def hist11(x, lo, hi):
        b = torch.floor((x - lo) / (hi - lo) * _NBINS).to(torch.int64)
        b = torch.clamp(b, 0, _NBINS - 1)
        onehot = (b[..., None] == iota).to(torch.float32)
        return torch.einsum("...nk,...nkb->...nb", nbf, onehot)

    # Open3D bin order: theta -> slots 0-10, alpha -> 11-21, phi -> 22-32.
    spfh = torch.cat(
        [hist11(theta, -math.pi, math.pi), hist11(alpha, -1.0, 1.0), hist11(phi, -1.0, 1.0)],
        dim=-1,
    ) * hist_incr[..., None]

    wgt = torch.where(nb, 1.0 / torch.clamp_min(d2, _EPS), 0.0)
    acc = torch.einsum("...nk,...nkj->...nj", wgt, gather_rows(spfh, idx))
    sub = acc.reshape(acc.shape[:-1] + (3, _NBINS)).sum(dim=-1)
    scale = torch.where(sub > 0, 100.0 / torch.clamp_min(sub, _EPS), 0.0)
    fpfh = acc * torch.repeat_interleave(scale, _NBINS, dim=-1) + spfh
    fpfh = torch.where(pc.mask[..., None], fpfh, 0.0)
    return pc.with_(features=fpfh)


def _bin11(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    b = torch.floor((x - lo) / (hi - lo) * _NBINS).to(torch.int64)
    return torch.clamp(b, 0, _NBINS - 1)


def _spfh_block(qp, qn, tp, tn, valid_t, r2: float):
    """SPFH contribution of one target block to every query point.

    qp, qn: [..., TQ, 3] query points / normals; tp, tn: [..., TT, 3] target
    points / normals; valid_t: [..., TT]; r2: the squared radius (fp32).
    Returns (hist [..., TQ, 33], count [..., TQ], W [..., TQ, TT]) with W =
    mask / |d|, the weights of the FPFH pass.
    """
    d = tp[..., None, :, :] - qp[..., :, None, :]  # [..., TQ, TT, 3]
    d2 = torch.sum(d * d, dim=-1)
    m = (d2 > _EPS) & (d2 <= r2) & valid_t[..., None, :]
    dist = torch.sqrt(torch.clamp_min(d2, _EPS))
    dn = d / dist[..., None]
    u = qn[..., :, None, :].expand(dn.shape)
    v = torch.linalg.cross(dn, u, dim=-1)
    vn = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)
    w = torch.linalg.cross(u, vn, dim=-1)
    nt = tn[..., None, :, :]
    f_alpha = torch.sum(vn * nt, dim=-1)
    f_phi = torch.sum(u * dn, dim=-1)
    f_theta = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))
    mf = m.to(torch.float32)
    iota = torch.arange(_NBINS, device=qp.device)
    # Each bin's count is a sum of 0 / 1 terms: exact in any order.
    hist = torch.cat([
        torch.sum(mf[..., None] * (_bin11(f, lo, hi)[..., None] == iota), dim=-2)
        for f, lo, hi in ((f_alpha, -1.0, 1.0), (f_phi, -1.0, 1.0),
                          (f_theta, -math.pi, math.pi))
    ], dim=-1)
    return hist, torch.sum(mf, dim=-1), mf / dist


def compute_fpfh(pc: PointCloud, radius: float, *, chunk: int = 512) -> PointCloud:
    """33-D FPFH of every valid point from all its neighbours in ``radius``
    (requires normals); masked rows get zero features."""
    pts = torch.where(pc.mask[..., None], pc.points, PAD_SENTINEL)
    nrm, mask = pc.normals, pc.mask
    n = pts.shape[-2]
    r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
    blocks = [slice(lo, lo + chunk) for lo in range(0, n, min(chunk, n))]

    # Pass 1: SPFH histograms and neighbour counts.
    hist = pts.new_zeros(pts.shape[:-1] + (FPFH_DIM,))
    cnt = pts.new_zeros(pts.shape[:-1])
    for b in blocks:
        h, c, _ = _spfh_block(pts, nrm, pts[..., b, :], nrm[..., b, :], mask[..., b], r2)
        hist, cnt = hist + h, cnt + c
    k = torch.clamp_min(cnt, 1.0)
    spfh = hist * (100.0 / k)[..., None]  # Open3D's hit weight: 100 / k_i

    # Pass 2: FPFH_i = SPFH_i + (1 / k_i) sum_j SPFH_j / |d_ij|.
    wsum = torch.zeros_like(spfh)
    for b in blocks:
        d = pts[..., None, b, :] - pts[..., :, None, :]
        d2 = torch.sum(d * d, dim=-1)
        m = (d2 > _EPS) & (d2 <= r2) & mask[..., None, b]
        wmat = m.to(torch.float32) / torch.sqrt(torch.clamp_min(d2, _EPS))
        wsum = wsum + wmat @ spfh[..., b, :]
    fpfh = spfh + wsum / k[..., None]
    return pc.with_(features=torch.where(mask[..., None], fpfh, 0.0))


def compute_fpfh_capped(pc: PointCloud, radius: float, *, max_nn: int = 100) -> PointCloud:
    """33-D FPFH with Open3D's semantics and its max_nn cap: the hybrid
    search (the max_nn nearest within ``radius``, self included and pinned
    at distance 0), then ``fpfh_from_knn``.  Requires normals."""
    pts = torch.where(pc.mask[..., None], pc.points, PAD_SENTINEL)
    d2, idx, valid = nn_topk(pts, pts, pc.mask, pc.mask, k=min(max_nn, pts.shape[-2]),
                             radius=radius, self_pairs=True)
    return fpfh_from_knn(pc, d2, idx, valid)
