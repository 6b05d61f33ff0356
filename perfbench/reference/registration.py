"""The plain reference that decides ``correct``: straightforward PyTorch, no
kernels, no batching, nothing of the program.

It works out, from the benchmark's own raw clouds and true poses, the answer
a registration of a pair should give, and the program's answers are judged
against it (``perfbench/lib/check.py``):

  - ``voxel_downsample``: one mean point per occupied voxel, voxels counted
    from the cloud's min bound (the reference project's grid);
  - ``knn_normals``: the smallest principal axis of each point's
    ``max_nn`` nearest neighbours within ``radius`` (self included);
  - ``icp_point_to_plane``: point-to-plane ICP on the downsampled clouds,
    started from the true pose and run until its step vanishes: the local
    optimum of the objective the pipeline's ICP stage minimises (point to
    nearest target point, inliers within the ICP threshold, target normals).

Precision: float32 points and distances, with TF32 as the caller sets it
(``torch.backends.cuda.matmul.allow_tf32``): off for the reference, on for
the control, which is this same code one precision below.  Nearest
neighbours and their distances come from ``torch.cdist`` (matrix products
on the card, on coordinates shifted by the target's centroid).  The 6 x 6
solves run in float64.
"""

from __future__ import annotations

import torch


def voxel_downsample(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """[V, 3] float32 voxel means of [N, 3] points (sums in float64)."""
    p = points.to(torch.float64)
    ijk = torch.floor((p - p.min(dim=0).values) / voxel).to(torch.int64)
    _, inv, counts = torch.unique(ijk, dim=0, return_inverse=True, return_counts=True)
    sums = torch.zeros((counts.shape[0], 3), dtype=torch.float64, device=p.device)
    sums.index_add_(0, inv, p)
    return (sums / counts[:, None].to(torch.float64)).to(torch.float32)


def voxel_count(points: torch.Tensor, voxel: float) -> int:
    """The number of occupied voxels of [N, 3] points."""
    p = points.to(torch.float64)
    ijk = torch.floor((p - p.min(dim=0).values) / voxel).to(torch.int64)
    return int(torch.unique(ijk, dim=0).shape[0])


def nearest(query: torch.Tensor, target: torch.Tensor):
    """(squared distance [Q], index [Q]) of each query's nearest target
    point, as ``torch.cdist`` gives them, over blocks of queries (at most
    2**29 distances a block)."""
    block = max(64, (1 << 29) // max(1, target.shape[0]))
    d2, idx = [], []
    for lo in range(0, query.shape[0], block):
        d, i = torch.cdist(query[lo:lo + block], target).min(dim=1)
        d2.append(d * d)
        idx.append(i)
    return torch.cat(d2), torch.cat(idx)


def knn_normals(points: torch.Tensor, radius: float, max_nn: int = 30) -> torch.Tensor:
    """[N, 3] unit normals (sign arbitrary) of [N, 3] points."""
    n = points.shape[0]
    d = torch.cdist(points, points)
    k = min(max_nn, n)
    dk, ik = torch.topk(d, k, dim=1, largest=False)
    w = (dk <= radius).to(torch.float64)
    nb = points.to(torch.float64)[ik]  # [N, k, 3]
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    mean = (nb * w[..., None]).sum(dim=1) / cnt[:, None]
    c = (nb - mean[:, None, :]) * w[..., None]
    cov = c.transpose(1, 2) @ c / cnt[:, None, None]
    _, vecs = torch.linalg.eigh(cov)
    return vecs[..., 0].to(torch.float32)


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w)
    K = torch.zeros((3, 3), dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 0] = -w[2], w[1], w[2]
    K[1, 2], K[2, 0], K[2, 1] = -w[0], -w[1], w[0]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(theta) < 1e-12:
        return eye + K
    return eye + torch.sin(theta) / theta * K + (1 - torch.cos(theta)) / theta ** 2 * (K @ K)


def icp_point_to_plane(src: torch.Tensor, tgt: torch.Tensor, tgt_normals: torch.Tensor,
                       T0: torch.Tensor, thresh: float, *, max_iterations: int = 60,
                       tol: float = 1e-10) -> tuple[torch.Tensor, float]:
    """(T [4, 4] float64, inlier RMSE at T) of point-to-plane ICP from T0.

    The clouds are shifted by the target's centroid for the search and the
    solves; T is returned in the caller's frame."""
    c = tgt.to(torch.float64).mean(dim=0)
    src_c = (src.to(torch.float64) - c).to(torch.float32)
    tgt_c = (tgt.to(torch.float64) - c).to(torch.float32)
    shift = torch.eye(4, dtype=torch.float64, device=src.device)
    shift[:3, 3] = c
    unshift = torch.eye(4, dtype=torch.float64, device=src.device)
    unshift[:3, 3] = -c
    T = unshift @ T0.to(torch.float64) @ shift  # pose in the centred frame
    nrm = tgt_normals.to(torch.float64)
    for _ in range(max_iterations):
        moved = (src_c.to(torch.float64) @ T[:3, :3].T + T[:3, 3]).to(torch.float32)
        d2, idx = nearest(moved, tgt_c)
        m = d2 < thresh * thresh
        p = moved.to(torch.float64)[m]
        q = tgt_c.to(torch.float64)[idx[m]]
        n = nrm[idx[m]]
        r = torch.sum((p - q) * n, dim=1)
        J = torch.cat([n, torch.linalg.cross(p, n)], dim=1)  # d r / d [t, w]
        x = torch.linalg.solve(J.T @ J, -(J.T @ r))
        step = torch.eye(4, dtype=torch.float64, device=src.device)
        step[:3, :3] = _rodrigues(x[3:])
        step[:3, 3] = x[:3]
        T = step @ T
        if float(torch.linalg.norm(x)) < tol:
            break
    moved = (src_c.to(torch.float64) @ T[:3, :3].T + T[:3, 3]).to(torch.float32)
    d2, _ = nearest(moved, tgt_c)
    m = d2 < thresh * thresh
    rmse = float(torch.sqrt(d2[m].to(torch.float64).mean())) if bool(m.any()) else 0.0
    return shift @ T @ unshift, rmse


def downsampled_answer(src: torch.Tensor, tgt: torch.Tensor, T_true: torch.Tensor, *,
                       voxel: float, normal_radius: float, normal_max_nn: int,
                       thresh: float) -> tuple[torch.Tensor, float]:
    """(T, inlier RMSE) a pair registered on its voxel-downsampled clouds
    should give: point-to-plane ICP from the true pose to its optimum."""
    sd, td = voxel_downsample(src, voxel), voxel_downsample(tgt, voxel)
    return icp_point_to_plane(sd, td, knn_normals(td, normal_radius, normal_max_nn), T_true,
                              thresh)

