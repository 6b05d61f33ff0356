"""Dense capped normals + FPFH over the [M, M] pair matrix (port of
tpu3dm/preprocess/dense.py), the stream's feature path.

Instead of kNN slots (``ops/topk.py`` -> ``normals_from_knn`` /
``fpfh_from_knn``) both stages run on the dense distance matrix:

  - the k-nearest cap becomes a per-row distance threshold (the k-th
    smallest distance), so neighbour selection is a boolean mask;
  - normals come from masked moment matmuls (W @ p, W @ p p^T) and the
    closed-form 3x3 eigensolver;
  - the FPFH pair features run over column chunks of CHUNK columns, each
    bin a masked count, and the neighbour accumulation is one [M, M] @
    [M, 33] matmul.

Semantics match the slot path (Open3D hybrid search, Feature.cpp binning)
but for exact distance ties at the k-th neighbour: the slot path keeps the
smaller index, the threshold keeps every tied entry.  No Pallas kernel is
on this path in JAX (XLA matmuls and ``lax.top_k``), so the plain PyTorch
here is the port.  The covariance is E[p p^T] - mu mu^T on points centred
by the cloud centroid.
"""

from __future__ import annotations

import math

import torch

from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud
from tpu3dm_torch.ops.eigh3 import smallest_eigvec_sym3
from tpu3dm_torch.preprocess.fpfh import _EPS, _NBINS, _pair_features

BIG = 1.0e12
# Column-chunk width of the SPFH pair-feature scan: every temporary is one
# [M, CHUNK] tile.  Bin counts are integer sums, so the chunking does not
# change the result.
CHUNK = 128


def _dense_d2(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[M, M] squared distances; rows and columns of invalid points BIG.

    The diagonal is pinned to exact zero: the |a|^2 + |b|^2 - 2ab form
    leaves up to ~1e-5 on the self-distance, which would leak the self-pair
    past FPFH's d2 > eps exclusion with a 1 / d^2 weight of ~1e5."""
    sq = torch.sum(pts * pts, dim=-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T), 0.0)
    d2 = d2.fill_diagonal_(0.0)
    ok = mask[:, None] & mask[None, :]
    return torch.where(ok, d2, BIG)


def down_features_dense(
    pc: PointCloud,
    normal_radius: float,
    fpfh_radius: float,
    *,
    normal_max_nn: int,
    fpfh_max_nn: int,
) -> PointCloud:
    """Capped normals + FPFH of one [M, 3] cloud over the dense pair matrix.

    A cap of 0 means uncapped (radius only); either cap may be the larger.
    Returns the cloud with its normals and 33-D features (masked rows 0).
    """
    m = pc.mask
    ctr = pc.centroid()
    pts = torch.where(m[:, None], pc.points - ctr[None, :], PAD_SENTINEL)
    n = pts.shape[0]
    d2 = _dense_d2(pts, m)
    r2_n = float(torch.tensor(normal_radius, dtype=torch.float32) ** 2)
    r2_f = float(torch.tensor(fpfh_radius, dtype=torch.float32) ** 2)

    # One top-k to the larger cap serves both thresholds (slots ascend).
    kf = min(fpfh_max_nn, n) if fpfh_max_nn > 0 else 0
    kn = min(normal_max_nn, n) if normal_max_nn > 0 else 0
    kmax = max(kf, kn)
    if kmax > 0:
        vals = -torch.topk(-d2, kmax, dim=-1).values  # [M, kmax] ascending
    full_f = torch.full((n,), r2_f, dtype=torch.float32, device=pts.device)
    full_n = torch.full((n,), r2_n, dtype=torch.float32, device=pts.device)
    th_f = torch.clamp_max(vals[:, kf - 1], r2_f) if kf > 0 else full_f
    th_n = torch.clamp_max(vals[:, kn - 1], r2_n) if kn > 0 else full_n

    # --- normals: masked moment matmuls + closed-form smallest eigvec -----
    wn = (d2 <= th_n[:, None]).to(torch.float32)  # includes self (d2 = 0)
    cnt_n = torch.clamp_min(wn.sum(dim=1), 1.0)
    pts0 = torch.where(m[:, None], pts, 0.0)  # sentinel rows never selected
    mean = (wn @ pts0) / cnt_n[:, None]
    outer = (pts0[:, :, None] * pts0[:, None, :]).reshape(n, 9)
    second = (wn @ outer).reshape(n, 3, 3) / cnt_n[:, None, None]
    cov = second - mean[:, :, None] * mean[:, None, :]
    _, v = smallest_eigvec_sym3(cov)
    flip = torch.sum(v * pts0, dim=1) < 0.0  # pre-centred: outward from the centroid
    v = torch.where(flip[:, None], -v, v)
    nrm = torch.where(m[:, None], v, 0.0)

    # --- FPFH: pair features over column chunks, per-bin masked counts ----
    def hist_of(x, lo, hi, nbc):
        b = torch.clamp(torch.floor((x - lo) / (hi - lo) * _NBINS).to(torch.int32),
                        0, _NBINS - 1)
        return torch.stack([torch.sum(torch.where((b == k) & nbc, 1.0, 0.0), dim=1)
                            for k in range(_NBINS)], dim=1)

    pad_c = (-n) % CHUNK
    if pad_c:  # far-away sentinel columns: never neighbours
        d2p = torch.cat([d2, torch.full((n, pad_c), BIG, device=pts.device)], dim=1)
        pts_cols = torch.cat([pts, torch.full((pad_c, 3), PAD_SENTINEL, device=pts.device)])
        nrm_cols = torch.cat([nrm, torch.zeros((pad_c, 3), device=pts.device)])
    else:
        d2p, pts_cols, nrm_cols = d2, pts, nrm
    counts33 = torch.zeros((n, 3 * _NBINS), dtype=torch.float32, device=pts.device)
    cnt = torch.zeros((n,), dtype=torch.float32, device=pts.device)
    for j0 in range(0, n + pad_c, CHUNK):
        d2c = d2p[:, j0:j0 + CHUNK]
        pjc, njc = pts_cols[j0:j0 + CHUNK], nrm_cols[j0:j0 + CHUNK]
        nbc = (d2c <= th_f[:, None]) & (d2c > _EPS)
        dp = pjc[None, :, :] - pts[:, None, :]
        theta, alpha, phi = _pair_features(
            pts, nrm, pjc[None].expand(n, -1, -1), njc[None].expand(n, -1, -1), dp,
            torch.sqrt(d2c), nbc)
        counts33 = counts33 + torch.cat(
            [hist_of(theta, -math.pi, math.pi, nbc), hist_of(alpha, -1.0, 1.0, nbc),
             hist_of(phi, -1.0, 1.0, nbc)], dim=1)
        cnt = cnt + torch.sum(nbc.to(torch.float32), dim=1)
    hist_incr = torch.where(cnt > 0, 100.0 / torch.clamp_min(cnt, 1.0), 0.0)
    spfh = counts33 * hist_incr[:, None]

    # Neighbour accumulation: ONE [M, M] @ [M, 33] matmul.
    nb = (d2 <= th_f[:, None]) & (d2 > _EPS)
    wgt = torch.where(nb, 1.0 / torch.clamp_min(d2, _EPS), 0.0)
    acc = wgt @ spfh
    sub = acc.reshape(n, 3, _NBINS).sum(dim=2)
    scale = torch.where(sub > 0, 100.0 / torch.clamp_min(sub, _EPS), 0.0)
    fpfh = acc * torch.repeat_interleave(scale, _NBINS, dim=1) + spfh
    fpfh = torch.where(m[:, None], fpfh, 0.0)
    return pc.with_(normals=nrm, features=fpfh)
