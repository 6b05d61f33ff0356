"""The plain reference of the full-resolution cell: straightforward PyTorch,
no kernels, nothing of the program.

It works out, from the benchmark's own raw clouds and true pose, the answer
the last stage of a full-resolution registration should reach: point-to-plane
ICP from every source point to its nearest full-resolution target point,
inliers within the ICP threshold, started from the true pose and run until
its step vanishes.

  - ``Grid``: the target's points bucketed in cubic cells of a side no
    smaller than the search radius, so that every target point within the
    radius of a query lies in the 27 cells around the query's cell.  Each
    query is searched against all of them: its neighbour is exact within
    the radius.  The candidates' distances are |q|^2 + |t|^2 - 2 q.t, the
    products by a batched matrix product, in float32, on coordinates taken
    about the target's centroid (under 7 units from it on the arch).  The
    candidates within ``MARGIN_ULPS`` units of float32's rounding of the
    least such distance (a bound on what that rounding can move it, about
    1e-4 here) are kept, and the nearest of them, by the same expansion in
    float64, is the neighbour: the exact nearest in float32.  TF32 rounds
    the products by about 1e-2, a hundred times the margin, and so moves
    the choice.  The picked neighbour's squared distance is then taken by
    differences in float64;
  - ``target_normals``: ``registration.knn_normals`` of the voxel-downsampled
    target (``registration.voxel_downsample``), each full-resolution target
    point taking the normal of its nearest downsampled point (searched
    within a voxel's diagonal, where the mean of its own voxel lies);
  - ``icp``: the point-to-plane Gauss-Newton steps (6 x 6 solves in float64,
    in a frame centred on the target's centroid) from the true pose until
    the step is below ``tol``, then the fitness (inliers over the source's
    points) and the inlier RMSE at the last pose.  Its cost is a few exact
    searches over the whole cloud, seconds a 1M-point pair on the card.

Precision: the neighbour choice follows TF32 as the caller sets it
(``torch.backends.cuda.matmul.allow_tf32``): off for the reference, on for
the control, which is this same code one precision below.  Poses, moved
points before they enter a frame, the picked distances and the solves are
float64.
"""

from __future__ import annotations

import math

import torch

from .registration import _rodrigues, knn_normals, voxel_downsample

# Candidate distances a batch of cells, so that a batch's few [G, Q, C]
# tensors stay near a gigabyte.
BATCH_ENTRIES = 1 << 25
# The margin of the float32 pick, in units of 2^-24 |p|^2 for the largest
# squared norm |p|^2 of the batch's coordinates: float32 rounds each of the
# expansion's three terms and its two sums, and its coordinates, by at most
# about 16 such units; two candidates' errors can differ by twice that.
MARGIN_ULPS = 40.0
# The 9 (di, dj) rows of cells around a cell; each holds 3 cells in k, one
# run of keys.
_ROWS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def _batches(q_counts: list[int], c_counts: list[int], budget: int) -> list[list[int]]:
    """Cells in batches whose padded queries x candidates fit ``budget``,
    cells of like candidate counts together."""
    order = sorted(range(len(c_counts)), key=lambda i: -c_counts[i])
    out, cur, qm, cm = [], [], 0, 0
    for i in order:
        q2, c2 = max(qm, q_counts[i]), max(cm, c_counts[i])
        if cur and (len(cur) + 1) * q2 * c2 > budget:
            out.append(cur)
            cur, q2, c2 = [], q_counts[i], c_counts[i]
        cur.append(i)
        qm, cm = q2, c2
    if cur:
        out.append(cur)
    return out


def cell_distances(ql: torch.Tensor, tl: torch.Tensor) -> torch.Tensor:
    """[G, Q, C] squared distances |q|^2 + |t|^2 - 2 q.t of [G, Q, 3] queries
    and [G, C, 3] candidates, in their dtype, the products by ``torch.bmm``.
    A fourth coordinate, 0, makes a float32 product one that follows the
    TF32 setting (the card runs batched products of three columns in
    float32 whatever it allows)."""
    q4 = torch.nn.functional.pad(ql, (0, 1))
    t4 = torch.nn.functional.pad(tl, (0, 1))
    return (torch.sum(ql * ql, dim=-1)[:, :, None] + torch.sum(tl * tl, dim=-1)[:, None, :]
            - 2.0 * torch.bmm(q4, t4.transpose(1, 2)))


class Grid:
    """A target cloud's points in cubic cells of side ``radius``, with one
    empty cell of margin on every side, so that the neighbours of a cell
    inside the grid never wrap onto occupied cells."""

    def __init__(self, target: torch.Tensor, radius: float) -> None:
        self.radius = float(radius)
        self.t64 = target.to(torch.float64)
        self.centre = self.t64.mean(dim=0)
        self.lo = self.t64.min(dim=0).values - self.radius
        ti = self._cells(self.t64)
        self.dims = ti.max(dim=0).values + 2
        key = self._key(ti[:, 0], ti[:, 1], ti[:, 2])
        self.t_order = torch.argsort(key)
        self.t_key = key[self.t_order]

    def _cells(self, p64: torch.Tensor) -> torch.Tensor:
        return torch.floor((p64 - self.lo) / self.radius).to(torch.int64)

    def _key(self, i, j, k):
        return (i * self.dims[1] + j) * self.dims[2] + k

    def nearest(self, query: torch.Tensor, *,
                budget: int = BATCH_ENTRIES) -> tuple[torch.Tensor, torch.Tensor]:
        """(squared distance [Q] float64, index [Q] int64) of each query's
        nearest target point within the 27 cells around it: exact for every
        query with a target within ``radius``; inf and -1 where the 27 cells
        hold no target."""
        dev = query.device
        q64 = query.to(torch.float64)
        nq, nt = q64.shape[0], self.t64.shape[0]
        d2_out = torch.full((nq,), math.inf, dtype=torch.float64, device=dev)
        idx_out = torch.full((nq,), -1, dtype=torch.int64, device=dev)
        qi = self._cells(q64)
        inside = torch.all((qi >= 0) & (qi < self.dims), dim=1)
        q_ids = torch.nonzero(inside).flatten()
        if q_ids.numel() == 0 or nt == 0:
            return d2_out, idx_out
        qi = qi[q_ids]
        q_key = self._key(qi[:, 0], qi[:, 1], qi[:, 2])
        q_order = torch.argsort(q_key)
        cells, q_count = torch.unique_consecutive(q_key[q_order], return_counts=True)
        q_start = torch.cumsum(q_count, 0) - q_count
        nyz = self.dims[1] * self.dims[2]
        ci, cj, ck = cells // nyz, (cells // self.dims[2]) % self.dims[1], cells % self.dims[2]
        first = torch.stack([self._key(ci + di, cj + dj, ck - 1) for di, dj in _ROWS], dim=1)
        t_lo = torch.searchsorted(self.t_key, first)
        n_row = torch.searchsorted(self.t_key, first + 3) - t_lo  # [C, 9]
        n_cand = n_row.sum(dim=1)
        row_end = torch.cumsum(n_row, dim=1)
        for b in _batches(q_count.tolist(), n_cand.tolist(), budget):
            g = torch.tensor(b, dtype=torch.int64, device=dev)
            qc, cc = q_count[g], n_cand[g]
            qm, cm = int(qc.max()), int(cc.max())
            if cm == 0:
                continue
            aq = torch.arange(qm, device=dev)
            q_ok = aq[None, :] < qc[:, None]
            qsel = q_ids[q_order[torch.clamp(q_start[g][:, None] + aq[None, :],
                                             max=q_ids.numel() - 1)]]
            ac = torch.arange(cm, device=dev).expand(len(b), cm).contiguous()
            r = torch.clamp(torch.searchsorted(row_end[g], ac, right=True), max=len(_ROWS) - 1)
            pos = torch.gather(t_lo[g], 1, r) + ac - torch.gather(row_end[g] - n_row[g], 1, r)
            c_ok = ac < cc[:, None]
            tsel = self.t_order[torch.clamp(pos, 0, nt - 1)]
            q_c, t_c = q64[qsel] - self.centre, self.t64[tsel] - self.centre
            d2 = cell_distances(q_c.to(torch.float32), t_c.to(torch.float32))
            d2 = d2.masked_fill(~c_ok[:, None, :], math.inf)
            norm = torch.maximum(torch.amax(torch.sum(q_c * q_c, dim=-1)),
                                 torch.amax(torch.sum(t_c * t_c, dim=-1)))
            near = d2 <= torch.amin(d2, dim=2, keepdim=True) + MARGIN_ULPS * 2.0 ** -24 * norm
            near &= c_ok[:, None, :]
            d2 = cell_distances(q_c, t_c).masked_fill(~near, math.inf)
            best, arg = torch.min(d2, dim=2)
            found = torch.gather(tsel, 1, arg)
            idx_out[qsel[q_ok]] = torch.where(torch.isfinite(best), found, -1)[q_ok]
        hit = idx_out >= 0
        d2_out[hit] = torch.sum((q64[hit] - self.t64[idx_out[hit]]) ** 2, dim=1)
        return d2_out, idx_out


def target_normals(tgt: torch.Tensor, *, voxel: float, normal_radius: float,
                   normal_max_nn: int) -> torch.Tensor:
    """[M, 3] float64 normals of the full-resolution target: each point takes
    the normal of its nearest voxel-downsampled target point."""
    down = voxel_downsample(tgt, voxel)
    nrm = knn_normals(down, normal_radius, normal_max_nn)
    _, idx = Grid(down, voxel * math.sqrt(3.0) * 1.001).nearest(tgt)
    return nrm.to(torch.float64)[idx]


def _fit(src64, grid: Grid, nrm, T, thresh: float, c):
    """(d2, idx, inlier mask, Gauss-Newton step [6]) at the pose T: the step
    (translation, rotation vector) of the point-to-plane objective in the
    frame centred on ``c``."""
    moved = src64 @ T[:3, :3].T + T[:3, 3]
    d2, idx = grid.nearest(moved)
    m = d2 < thresh * thresh
    p = moved[m] - c
    q = grid.t64[idx[m]] - c
    n = nrm[idx[m]]
    r = torch.sum((p - q) * n, dim=1)
    J = torch.cat([n, torch.linalg.cross(p, n)], dim=1)  # d r / d [t, w]
    if int(m.sum()) < 6:
        return d2, m, torch.zeros(6, dtype=torch.float64, device=src64.device)
    return d2, m, torch.linalg.solve(J.T @ J, -(J.T @ r))


def icp(src: torch.Tensor, tgt: torch.Tensor, T0: torch.Tensor, *, voxel: float,
        normal_radius: float, normal_max_nn: int, thresh: float, max_iterations: int = 30,
        tol: float = 1e-6) -> tuple[torch.Tensor, float, float, int]:
    """(T [4, 4] float64, fitness, inlier RMSE, steps taken): point-to-plane
    ICP at full resolution from T0 until the step's norm (radians and
    units) is below ``tol``.  The neighbours change in jumps, so the step
    does not vanish: near the optimum it wanders at about 1e-6 at 16k
    points, less at more."""
    nrm = target_normals(tgt, voxel=voxel, normal_radius=normal_radius,
                         normal_max_nn=normal_max_nn)
    grid = Grid(tgt, thresh)
    src64 = src.to(torch.float64)
    c = grid.t64.mean(dim=0)
    T = T0.to(torch.float64)
    steps = 0
    for _ in range(max_iterations):
        _, _, x = _fit(src64, grid, nrm, T, thresh, c)
        S = torch.eye(4, dtype=torch.float64, device=T.device)
        S[:3, :3] = _rodrigues(x[3:])
        S[:3, 3] = x[:3] + c - S[:3, :3] @ c
        T = S @ T
        steps += 1
        if float(torch.linalg.norm(x)) < tol:
            break
    d2, m, _ = _fit(src64, grid, nrm, T, thresh, c)
    n_in = int(m.sum())
    rmse = float(torch.sqrt(d2[m].mean())) if n_in else 0.0
    return T, n_in / max(1, src.shape[0]), rmse, steps
