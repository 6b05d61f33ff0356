"""33-D FPFH from kNN slots (port of tpu3dm/preprocess/fpfh.py:fpfh_from_knn).

Open3D semantics: the PCL source/target swap rule per pair, bin order
(theta | alpha | phi), neighbour weighting by 1 / squared distance, and each
11-bin sub-histogram of the neighbour sum normalised to 100 before the
self-SPFH is added.
"""

from __future__ import annotations

import math

import torch

from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud
from tpu3dm_torch.ops.topk import gather_rows

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
