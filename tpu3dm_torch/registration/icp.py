"""ICP refinement, point-to-plane and point-to-point (port of tpu3dm/registration/icp.py).

Each iteration: transform -> NN search (``ops.nn.nn_search``: dense up to
16M entries, the tiled kernel above) -> weighted 6x6 normal equations ->
SE(3) exponential update.  The JAX ``while_loop`` becomes a Python loop
whose convergence test (Open3D's: ABSOLUTE deltas of fitness and RMSE
below the fields named relative_*) is read on the host once an iteration.

A batch of poses [..., 4, 4] runs one ICP a pose against the same clouds:
each pose takes its own steps and stops on its own test (a stopped pose
stays where its test passed), and one host read an iteration serves them
all.  One pose [4, 4] is a batch of none.

``cuda_graph``: on CUDA, iteration 1 is captured as one CUDA graph whose
replays advance the loop's state in place; every later iteration is a
replay, so the host launches the ~200 small ops of an iteration once a
call, not once an iteration.  The replays run the eager loop's kernels on
the same values: the result is the eager loop's, bit for bit.  The graphs'
pool, stream, turns and launch counts are ``registration/graphs.py``'s.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import IcpConfig
from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.parallel.multipair import f32_square
from tpu3dm_torch.registration.graphs import device_graphs
from tpu3dm_torch.registration.result import RegistrationResult


def masked_fit(d2: torch.Tensor, m: torch.Tensor, n_src) -> tuple[torch.Tensor, torch.Tensor]:
    """(fitness, inlier RMSE) of correspondences with squared distances d2
    and inlier mask m [..., N], over n_src valid source points."""
    fitness = torch.sum(m.to(torch.float32), dim=-1) / n_src
    rmse = torch.sqrt(torch.sum(torch.where(m, d2, 0.0), dim=-1)
                      / torch.clamp_min(torch.sum(m, dim=-1), 1))
    return fitness, rmse


def gauss_newton_step(T, pts, q, n, m, point_to_plane: bool) -> torch.Tensor:
    """exp(xi) @ T for the Gauss-Newton step xi of the weighted residuals of
    moved source points ``pts`` [..., N, 3] against their matches ``q``
    (normals ``n`` for point-to-plane), inlier weights ``m`` [..., N] bool;
    one step a pose of T [..., 4, 4]."""
    w = m.to(torch.float32)
    if point_to_plane:
        r = torch.sum((pts - q) * n, dim=-1)  # signed plane residual
        J = torch.cat([n, torch.cross(pts, n, dim=-1)], dim=-1)  # [..., N, 6]
    else:
        eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(*pts.shape[:-1], 3, 3)
        J = torch.cat([eye, -se3.hat(pts)], dim=-1).reshape(*pts.shape[:-2], -1, 6)
        r = (pts - q).reshape(*pts.shape[:-2], -1)
        w = torch.repeat_interleave(w, 3, dim=-1)
    A = torch.einsum("...n,...ni,...nj->...ij", w, J, J)
    b = -torch.einsum("...n,...ni,...n->...i", w, J, r)
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    # torch.trace's sum on the CPU (float64, in order), a pose at a time
    trace = torch.diagonal(A, dim1=-2, dim2=-1).to(torch.float64).sum(dim=-1).to(A.dtype)
    A = A + (1e-6 * trace / 6.0)[..., None, None] * eye6 + 1e-12 * eye6
    xi = torch.linalg.solve_ex(A, b).result  # no host sync; a failed solve is caught below
    xi = torch.where(torch.all(torch.isfinite(xi), dim=-1, keepdim=True), xi, 0.0)
    return se3.exp_se3(xi) @ T


def icp_loop(
    correspond, tgt_points, tgt_normals, T, *,
    max_iterations: int, relative_fitness: float, relative_rmse: float,
    cuda_graph: bool = False,
) -> RegistrationResult:
    """The ICP iteration shared by ``icp_refine`` and the large-cloud ICP.

    ``correspond(T)`` gives (moved source points, match indices into
    ``tgt_points``, inlier mask, fitness, RMSE), each with T's batch shape
    in front; point-to-plane when ``tgt_normals`` is given.  A pose stops
    after ``max_iterations`` or when both its fitness and RMSE moved by less
    than their thresholds (Open3D's test: absolute deltas, fp32); the loop
    ends when every pose has stopped, and grades the final transforms.
    ``iterations``: each pose's steps (int32 on the host, T's batch shape).
    ``cuda_graph``: replay iterations after the first as a CUDA graph where
    T lies on CUDA (the module docstring); ignored elsewhere.
    """
    batch = T.shape[:-2]
    f_cur = r_cur = torch.full(batch, -1.0, dtype=torch.float32, device=T.device)
    live = torch.ones(batch, dtype=torch.bool, device=T.device)
    live_host = torch.ones(batch, dtype=torch.bool)
    iterations = torch.zeros(batch, dtype=torch.int32)

    def advance(T, live, f_cur, r_cur, test: bool = True):
        pts, idx, m, f_new, r_new = correspond(T)
        n = None if tgt_normals is None else tgt_normals[idx]
        step = gauss_newton_step(T, pts, tgt_points[idx], n, m, tgt_normals is not None)
        T = torch.where(live[..., None, None], step, T)
        if test:
            live = live & ~((torch.abs(f_new - f_cur) < relative_fitness)
                            & (torch.abs(r_new - r_cur) < relative_rmse))
        return T, live, f_new, r_new

    def in_place(*state):  # a replay writes the next state over this one
        for dst, src in zip(state, advance(*state)):
            dst.copy_(src)
        return ()

    state, graph = (T, live, f_cur, r_cur), None
    graphs = device_graphs(T.device) if cuda_graph else None
    for it in range(max_iterations):
        if graph is None and graphs is not None and it > 0:
            state = tuple(t.clone() for t in state)  # outside the pool
            graph = graphs.capture(in_place, state)
        if graph is None:
            state = advance(*state, test=it > 0)
        else:
            graphs.replay(graph)
        iterations += live_host
        if 0 < it < max_iterations - 1:
            live_host = state[1].cpu()
            if not bool(torch.any(live_host)):
                break
    T = state[0]
    _, _, _, fitness, rmse = correspond(T)
    return RegistrationResult(
        transformation=T, fitness=fitness, inlier_rmse=rmse, iterations=iterations,
    )


def icp_refine(
    src: PointCloud,
    tgt: PointCloud,
    init_T: torch.Tensor,
    *,
    dist_thresh: float,
    max_iterations: int = 30,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    point_to_plane: bool = True,
    cuda_graph: bool = False,
) -> RegistrationResult:
    """Refine ``init_T`` (target <- source) by ICP: one pose [4, 4], or a
    batch [..., 4, 4] refined pose by pose (the module's batch rule).
    ``cuda_graph``: see ``icp_loop``.

    fitness = inliers / valid source points, inlier_rmse = RMSE of the inlier
    correspondence distances (Open3D RegistrationResult semantics).
    """
    thresh_sq = f32_square(dist_thresh)
    n_src = torch.clamp_min(torch.sum(src.mask), 1).to(torch.float32)

    def correspond(T):
        pts = se3.apply(T, src.points).contiguous()
        d2, idx = nn_search(pts, tgt.points, src.mask.expand(pts.shape[:-1]), tgt.mask)
        m = (d2 < thresh_sq) & src.mask
        return pts, idx.to(torch.int64), m, *masked_fit(d2, m, n_src)

    return icp_loop(
        correspond, tgt.points, tgt.normals if point_to_plane else None,
        torch.as_tensor(init_T, dtype=torch.float32, device=src.points.device),
        max_iterations=max_iterations, relative_fitness=relative_fitness,
        relative_rmse=relative_rmse, cuda_graph=cuda_graph,
    )


def refine_registration(
    src: PointCloud, tgt: PointCloud, init_T: torch.Tensor, config: IcpConfig
) -> RegistrationResult:
    """ICP with the configuration's threshold, budget, criteria and metric."""
    return icp_refine(
        src, tgt, init_T,
        dist_thresh=config.dist_thresh,
        max_iterations=config.max_iterations,
        relative_fitness=config.relative_fitness,
        relative_rmse=config.relative_rmse,
        point_to_plane=config.point_to_plane,
    )
