"""Dense capped normals + FPFH over the [M, M] pair matrix (port of
tpu3dm/preprocess/dense.py), the stream's feature path, batched over clouds.

Instead of kNN slots (``ops/topk.py`` -> ``normals_from_knn`` /
``fpfh_from_knn``) both stages run on the dense distance matrix:

  - the k-nearest cap becomes a per-row distance threshold (the k-th
    smallest distance), so neighbour selection is a boolean mask;
  - normals come from masked moment products (W @ [p, p p^T]) and the
    closed-form 3x3 eigensolver;
  - the FPFH pair features run over column chunks of CHUNK columns, each
    feature's bin counted by a scatter-add of the neighbour mask, and the
    neighbour accumulation is one [M, M] @ [M, 33] product.

Semantics match the slot path (Open3D hybrid search, Feature.cpp binning)
but for exact distance ties at the k-th neighbour: the slot path keeps the
smaller index, the threshold keeps every tied entry.  No Pallas kernel is
on this path in JAX (XLA matmuls and ``lax.top_k``), so the plain PyTorch
here is the port.  The covariance is E[p p^T] - mu mu^T on points centred
by the cloud centroid.

JAX ``vmap``s the one-cloud function over the stream's 2W clouds; here the
clouds are a leading axis [C, M, 3], cut into chunks of at most
``DENSE_PLANE_BYTES`` per [C, M, M] fp32 plane.  A cloud's result does not
depend on which clouds share its batch or chunk: everything elementwise
runs batched, the bin counts are sums of 0 and 1 (exact in any order), and
the three reductions over a cloud's M rows whose order a batched kernel
could pick by batch size (the centroid and the two moment products) run
one cloud at a time, at the same shapes whatever the batch.
"""

from __future__ import annotations

import math

import torch

from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud
from tpu3dm_torch.ops.eigh3 import smallest_eigvec_sym3
from tpu3dm_torch.preprocess.fpfh import _EPS, _NBINS, _pair_features

BIG = 1.0e12
# Column-chunk width of the SPFH pair-feature scan: every temporary is a
# [C, M, CHUNK] tile.  Bin counts are integer sums, so the chunking does not
# change the result.
CHUNK = 128
# Bytes of one [C, M, M] fp32 plane in a chunk of clouds.  A chunk's peak
# holds ~7.5 planes' worth of temporaries (the distances, the moment weights,
# the pair-feature tiles; chip_smoke.py path S5 on an H100: 256 clouds at
# M = 896).  At M = 896 a plane of 1 GiB holds 334 clouds, so a 128-pair
# window (256 clouds, 0.82 GB a plane) is one chunk.
DENSE_PLANE_BYTES = 1 << 30


def _dense_d2(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[C, M, M] squared distances; rows and columns of invalid points BIG.

    |a|^2 + |b|^2 - 2 a.b with the dot as three ordered elementwise
    products.  The diagonal is pinned to exact zero: the form leaves up to
    ~1e-5 on the self-distance, which would leak the self-pair past FPFH's
    d2 > eps exclusion with a 1 / d^2 weight of ~1e5."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    sq = x * x + y * y + z * z
    cross = x[:, :, None] * x[:, None, :]
    term = y[:, :, None] * y[:, None, :]
    cross += term
    torch.mul(z[:, :, None], z[:, None, :], out=term)
    cross += term
    del term
    d2 = sq[:, :, None] + sq[:, None, :]
    d2 -= cross.mul_(2.0)
    del cross
    d2.clamp_min_(0.0)
    d2.diagonal(dim1=1, dim2=2).zero_()
    ok = mask[:, :, None] & mask[:, None, :]
    return d2.masked_fill_(~ok, BIG)


def _per_cloud_products(w: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """w[c] @ rhs[c] for each cloud c: [C, M, M] @ [C, M, K] -> [C, M, K],
    one product a cloud, so its summation order does not follow the batch."""
    return torch.stack([w[c] @ rhs[c] for c in range(w.shape[0])])


def _per_cloud_centroids(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[C, 3] mask-aware centroids (``PointCloud.centroid``), one cloud at a time."""
    out = []
    for p, m in zip(points, mask):
        w = m.to(p.dtype)[:, None]
        out.append((p * w).sum(0) / torch.clamp_min(w.sum(0), 1.0))
    return torch.stack(out)


def _bins(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(torch.floor((x - lo) / (hi - lo) * _NBINS).to(torch.int64),
                       0, _NBINS - 1)


def _features_chunk(points, mask, r2_n, r2_f, normal_max_nn, fpfh_max_nn):
    """(normals [C, M, 3], FPFH [C, M, 33]) of a chunk of clouds."""
    c, n = mask.shape
    dev = points.device
    ctr = _per_cloud_centroids(points, mask)
    pts = torch.where(mask[..., None], points - ctr[:, None, :], PAD_SENTINEL)
    d2 = _dense_d2(pts, mask)

    # One top-k to the larger cap serves both thresholds (slots ascend).
    kf = min(fpfh_max_nn, n) if fpfh_max_nn > 0 else 0
    kn = min(normal_max_nn, n) if normal_max_nn > 0 else 0
    kmax = max(kf, kn)
    if kmax > 0:
        vals = torch.topk(d2, kmax, dim=-1, largest=False).values  # [C, M, kmax] ascending
    full_f = torch.full((c, n), r2_f, dtype=torch.float32, device=dev)
    full_n = torch.full((c, n), r2_n, dtype=torch.float32, device=dev)
    th_f = torch.clamp_max(vals[..., kf - 1], r2_f) if kf > 0 else full_f
    th_n = torch.clamp_max(vals[..., kn - 1], r2_n) if kn > 0 else full_n

    # --- normals: masked moment products + closed-form smallest eigvec ----
    wn = (d2 <= th_n[..., None]).to(torch.float32)  # includes self (d2 = 0)
    cnt_n = torch.clamp_min(wn.sum(dim=-1), 1.0)
    pts0 = torch.where(mask[..., None], pts, 0.0)  # sentinel rows never selected
    outer = (pts0[..., :, None] * pts0[..., None, :]).reshape(c, n, 9)
    mom = _per_cloud_products(wn, torch.cat([pts0, outer], dim=-1))
    del wn
    mean = mom[..., :3] / cnt_n[..., None]
    second = mom[..., 3:].reshape(c, n, 3, 3) / cnt_n[..., None, None]
    cov = second - mean[..., :, None] * mean[..., None, :]
    _, v = smallest_eigvec_sym3(cov)
    flip = torch.sum(v * pts0, dim=-1) < 0.0  # pre-centred: outward from the centroid
    v = torch.where(flip[..., None], -v, v)
    nrm = torch.where(mask[..., None], v, 0.0)

    # --- FPFH: pair features over column chunks, bins by scatter-add -------
    chunk = CHUNK
    pad_c = (-n) % chunk
    if pad_c:  # far-away sentinel columns: never neighbours
        d2p = torch.cat([d2, torch.full((c, n, pad_c), BIG, device=dev)], dim=-1)
        pts_cols = torch.cat([pts, torch.full((c, pad_c, 3), PAD_SENTINEL, device=dev)], dim=1)
        nrm_cols = torch.cat([nrm, torch.zeros((c, pad_c, 3), device=dev)], dim=1)
    else:
        d2p, pts_cols, nrm_cols = d2, pts, nrm
    counts33 = torch.zeros((c, n, 3 * _NBINS), dtype=torch.float32, device=dev)
    cnt = torch.zeros((c, n), dtype=torch.float32, device=dev)
    for j0 in range(0, n + pad_c, chunk):
        d2c = d2p[..., j0:j0 + chunk]
        pjc, njc = pts_cols[:, j0:j0 + chunk], nrm_cols[:, j0:j0 + chunk]
        w = pjc.shape[1]
        nbc = (d2c <= th_f[..., None]) & (d2c > _EPS)
        dp = pjc[:, None, :, :] - pts[:, :, None, :]
        theta, alpha, phi = _pair_features(
            pts, nrm, pjc[:, None].expand(c, n, w, 3), njc[:, None].expand(c, n, w, 3), dp,
            torch.sqrt(d2c), nbc)
        idx = torch.stack([_bins(theta, -math.pi, math.pi),
                           _bins(alpha, -1.0, 1.0) + _NBINS,
                           _bins(phi, -1.0, 1.0) + 2 * _NBINS], dim=-1)
        hit = nbc.to(torch.float32)
        counts33.scatter_add_(-1, idx.reshape(c, n, 3 * w),
                              hit[..., None].expand(c, n, w, 3).reshape(c, n, 3 * w))
        cnt = cnt + torch.sum(hit, dim=-1)
    hist_incr = torch.where(cnt > 0, 100.0 / torch.clamp_min(cnt, 1.0), 0.0)
    spfh = counts33 * hist_incr[..., None]

    # Neighbour accumulation: ONE [M, M] @ [M, 33] product a cloud.
    nb = (d2 <= th_f[..., None]) & (d2 > _EPS)
    wgt = torch.where(nb, 1.0 / torch.clamp_min(d2, _EPS), 0.0)
    del d2, d2p, nb
    acc = _per_cloud_products(wgt, spfh)
    sub = acc.reshape(c, n, 3, _NBINS).sum(dim=-1)
    scale = torch.where(sub > 0, 100.0 / torch.clamp_min(sub, _EPS), 0.0)
    fpfh = acc * torch.repeat_interleave(scale, _NBINS, dim=-1) + spfh
    return nrm, torch.where(mask[..., None], fpfh, 0.0)


def down_features_dense(
    pc: PointCloud,
    normal_radius: float,
    fpfh_radius: float,
    *,
    normal_max_nn: int,
    fpfh_max_nn: int,
) -> PointCloud:
    """Capped normals + FPFH over the dense pair matrix, of one [M, 3] cloud
    or of C clouds [C, M, 3] (JAX's ``vmap`` of the one-cloud function).

    A cap of 0 means uncapped (radius only); either cap may be the larger.
    Returns the clouds with their normals and 33-D features (masked rows 0);
    a cloud's values do not depend on the other clouds of the call.
    """
    if pc.points.ndim == 2:
        one = down_features_dense(
            PointCloud(*(x[None] for x in (pc.points, pc.mask, pc.normals, pc.features))),
            normal_radius, fpfh_radius, normal_max_nn=normal_max_nn, fpfh_max_nn=fpfh_max_nn)
        return pc.with_(normals=one.normals[0], features=one.features[0])
    r2_n = float(torch.tensor(normal_radius, dtype=torch.float32) ** 2)
    r2_f = float(torch.tensor(fpfh_radius, dtype=torch.float32) ** 2)
    c, n = pc.mask.shape
    step = max(1, DENSE_PLANE_BYTES // (4 * n * n))
    parts = [_features_chunk(pc.points[lo:lo + step], pc.mask[lo:lo + step], r2_n, r2_f,
                             normal_max_nn, fpfh_max_nn)
             for lo in range(0, c, step)]
    return pc.with_(normals=torch.cat([p[0] for p in parts]),
                    features=torch.cat([p[1] for p in parts]))
