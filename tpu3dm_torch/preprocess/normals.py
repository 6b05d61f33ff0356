"""Normal estimation (port of tpu3dm/preprocess/normals.py).

Two ways to a point's neighbourhood covariance, both ending in its smallest
eigenvector (ops/eigh3), oriented outward from the cloud centroid, with
masked rows zero:

  - ``estimate_normals``: every point within the radius (self included),
    from blocked moment sums (``radius_covariance_stats``: count, sum and
    the six unique entries of sum p p^T over a [query block, target block]
    distance slab at a time);
  - ``normals_from_knn`` / ``estimate_normals_capped``: the max_nn nearest
    points within the radius (Open3D's hybrid search), from kNN slots.

No Pallas kernel is on either route in JAX (XLA matmuls and ``lax.top_k``),
so the plain PyTorch here is the port.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud
from tpu3dm_torch.ops.eigh3 import smallest_eigvec_sym3
from tpu3dm_torch.ops.nn import lane_slices
from tpu3dm_torch.ops.topk import gather_rows, nn_topk

# Query rows of one block of radius_covariance_stats: JAX streams query
# blocks of this size once a cloud is larger (its 8192 x 1024 slabs are 32 MB).
QUERY_CHUNK = 8192


def radius_covariance_stats(
    points: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    *,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbourhood moments within ``radius`` (self included), blockwise.

    Returns (count [N], sum [N, 3], sumsq [N, 6]); a sumsq row holds the
    unique entries (xx, yy, zz, xy, xz, yz) of sum p p^T over the
    neighbours.  Target blocks of ``chunk`` rows are accumulated in order
    into each query block of QUERY_CHUNK rows, as JAX's scan does, so no
    temporary passes a [QUERY_CHUNK, chunk] slab.
    """
    n = points.shape[0]
    r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
    safe = torch.where(mask[:, None], points, PAD_SENTINEL)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    p2cols = torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=1)
    chunk = min(chunk, n)
    tsq = torch.sum(safe * safe, dim=-1)
    cnt = torch.zeros((n,), dtype=torch.float32, device=points.device)
    s = torch.zeros((n, 3), dtype=torch.float32, device=points.device)
    ss = torch.zeros((n, 6), dtype=torch.float32, device=points.device)
    for q0 in range(0, n, QUERY_CHUNK):
        qs = slice(q0, min(q0 + QUERY_CHUNK, n))
        q, q2 = safe[qs], tsq[qs]
        for t0 in range(0, n, chunk):
            ts = slice(t0, min(t0 + chunk, n))
            d2 = q2[:, None] + tsq[None, ts] - 2.0 * (q @ safe[ts].T)
            mf = ((d2 <= r2) & mask[None, ts]).to(torch.float32)
            cnt[qs] += torch.sum(mf, dim=1)
            s[qs] += mf @ safe[ts]
            ss[qs] += mf @ p2cols[ts]
    return cnt, s, ss


def _covariance_from_stats(cnt: torch.Tensor, s: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] covariance E[p p^T] - mean mean^T from the moments."""
    k = torch.clamp_min(cnt, 1.0)[:, None]
    mean = s / k
    exx = ss / k
    xx = exx[:, 0] - mean[:, 0] * mean[:, 0]
    yy = exx[:, 1] - mean[:, 1] * mean[:, 1]
    zz = exx[:, 2] - mean[:, 2] * mean[:, 2]
    xy = exx[:, 3] - mean[:, 0] * mean[:, 1]
    xz = exx[:, 4] - mean[:, 0] * mean[:, 2]
    yz = exx[:, 5] - mean[:, 1] * mean[:, 2]
    return torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=1).reshape(-1, 3, 3)


def _oriented(pc: PointCloud, cov: torch.Tensor) -> PointCloud:
    """The smallest eigenvectors of ``cov``, pointed away from the centroid,
    zero at masked rows."""
    _, v = smallest_eigvec_sym3(cov)
    outward = pc.points - pc.centroid()[..., None, :]
    flip = torch.sum(v * outward, dim=-1) < 0.0
    v = torch.where(flip[..., None], -v, v)
    v = torch.where(pc.mask[..., None], v, 0.0)
    return pc.with_(normals=v)


def estimate_normals(pc: PointCloud, radius: float, *, chunk: int = 1024) -> PointCloud:
    """Unit normals from the covariance of every point within ``radius``.
    A point with fewer than 3 neighbours gets the eigensolver's fallback."""
    cnt, s, ss = radius_covariance_stats(pc.points, pc.mask, radius, chunk=chunk)
    return _oriented(pc, _covariance_from_stats(cnt, s, ss))


def _knn_covariance(points: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[..., N, 3, 3] covariance of the valid neighbour slots (idx, valid
    [..., N, K]).

    The slot sums run in slot order as elementwise ops, so a cloud's
    covariance has the same bits alone or in a batch of clouds (a batched
    matmul's summation order depends on the batch)."""
    pj = gather_rows(points, idx)  # [..., N, K, 3]
    w = valid.to(torch.float32)
    cnt = torch.clamp_min(torch.sum(w, dim=-1), 1.0)  # whole numbers: exact in any order
    s = pj[..., 0, :] * w[..., 0, None]
    for k in range(1, pj.shape[-2]):
        s = s + pj[..., k, :] * w[..., k, None]
    c = (pj - (s / cnt[..., None])[..., None, :]) * w[..., None]
    cov = c[..., 0, :, None] * c[..., 0, None, :]
    for k in range(1, c.shape[-2]):
        cov = cov + c[..., k, :, None] * c[..., k, None, :]
    return cov / cnt[..., None, None]


def normals_from_knn(pc: PointCloud, idx: torch.Tensor, valid: torch.Tensor) -> PointCloud:
    """Normals of a cloud ([N, 3] points), or of a batch of clouds ([B, N,
    3]), from precomputed kNN slots."""
    return _oriented(pc, _knn_covariance(pc.points, idx, valid))


def estimate_normals_capped(pc: PointCloud, radius: float, *, max_nn: int = 30) -> PointCloud:
    """Normals from the max_nn nearest neighbours within ``radius`` (self
    included), Open3D's hybrid search.  The kNN scan runs over query slices,
    so no distance slab passes 256 MB; each row's neighbours do not depend
    on the slicing."""
    n = pc.points.shape[0]
    safe = torch.where(pc.mask[:, None], pc.points, PAD_SENTINEL)
    idxs, valids = [], []
    for s in lane_slices(n, n):
        _, idx, valid = nn_topk(safe[s], safe, pc.mask[s], pc.mask, k=min(max_nn, n),
                                radius=radius)
        idxs.append(idx)
        valids.append(valid)
    return normals_from_knn(pc, torch.cat(idxs), torch.cat(valids))
