"""Multi-way registration: pairwise fan-out + pose-graph solve (port of
tpu3dm/multiway/posegraph.py).

  1. Pairwise registration of an edge list (chain + loop-closure edges by
     default): ``register_multiway`` runs one ``register_pair`` an edge,
     ``register_multiway_batched`` one ``fused_register_step`` over a chunk
     of up to 128 edges.
  2. Pose-graph optimization: absolute poses {P_i} (P_0 = I, the gauge)
     minimizing sum_e w_e || log_se3(T_e^-1 P_je^-1 P_ie) ||^2 by
     Gauss-Newton on SE(3), right perturbations, Jacobians by forward-mode
     AD (``torch.func``), as JAX's ``jax.jacfwd``.

No Pallas kernel is on this path in JAX (XLA ops and ``jnp.linalg``
solves), so the solve is plain PyTorch on the edges' device.  Where JAX's
solves return NaN (a singular or non-positive-definite system), the port's
``_ex`` solves report it in ``info`` without a host sync; either way the
step is set to zero on the device, as JAX's all-finite guard does.

Randomness: JAX splits one key per edge.  ``register_multiway`` draws one
seed an edge from ``generator`` (cached edge or not, so a resumed run
equals an uninterrupted one) or takes each edge's ``register_pair`` bits
from ``edge_bits``; ``register_multiway_batched`` draws each edge's
``fused_register_step`` bits (``batch.pair_bits_shape``) in edge order or
takes ``edge_bits``.  With a ``mesh`` the batched fan-out splits each
chunk of edges, with their bits, over the mesh's pair axis (parallel/).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import round_up
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.multiway.checkpoint import CheckpointStore, EdgeRecord
from tpu3dm_torch.parallel.mesh import PAIR_AXIS, check_mesh, map_shards
from tpu3dm_torch.parallel.multipair import draw_bits

# Node count from which the solve assembles edgewise Jacobian blocks (O(E)
# work) instead of the full-graph jacfwd (O(N) seeds): JAX's threshold.
_EDGEWISE_THRESHOLD = 65
# Edges a fused_register_step call takes: JAX's chunk of the edge axis.
EDGE_CHUNK = 128


def _graph_inputs(T_meas, edges, weights):
    T_meas = torch.as_tensor(T_meas, dtype=torch.float32)
    dev = T_meas.device
    if not torch.is_tensor(edges):
        edges = np.asarray(edges)
    edges = torch.as_tensor(edges, dtype=torch.int64, device=dev)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    return T_meas, edges, weights


def _gauge_mask(n_nodes: int, dev) -> torch.Tensor:
    """[6N]: 0 on node 0's coordinates, 1 elsewhere."""
    return torch.cat([torch.zeros(6, device=dev), torch.ones((n_nodes - 1) * 6, device=dev)])


def _gm_factor(rn2: torch.Tensor, robust_delta: float) -> torch.Tensor:
    """Geman-McClure IRLS weight (d^2 / (d^2 + ||r||^2))^2, d^2 in fp32."""
    d2 = float(np.float32(robust_delta) ** 2)
    return (d2 / (d2 + rn2)) ** 2


def _guarded(delta: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """``delta`` when every entry is finite and the solve succeeded, else
    zeros, decided on the device."""
    ok = torch.all(torch.isfinite(delta)) & torch.all(info == 0)
    return torch.where(ok, delta, torch.zeros_like(delta))


def _identity_poses(n_nodes: int, dev) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=dev).expand(n_nodes, 4, 4).contiguous()


def optimize_pose_graph(
    T_meas,
    edges,
    weights,
    *,
    n_nodes: int,
    iterations: int = 20,
    damping: float = 1e-6,
    robust_delta: float | None = None,
) -> torch.Tensor:
    """Absolute poses from relative measurements, on ``T_meas``'s device.

    Args:
      T_meas: [E, 4, 4] relative transforms; edge e = (i, j) satisfies
        x_j ~= T_e x_i for points in the two clouds' frames.
      edges: [E, 2] (i, j) node indices.
      weights: [E] nonnegative edge weights (e.g. registration fitness).
      n_nodes: number of clouds N.
      iterations: Gauss-Newton iterations from identity poses.
      robust_delta: None = least squares; a float enables JAX's
        Geman-McClure IRLS, each step reweighting edge e by (d^2 / (d^2 +
        ||r_e||^2))^2 after max(1, iterations // 3) unweighted steps.

    Each step: the full-graph Jacobian by ``torch.func.jacfwd`` over the
    [N, 6] tangent, node 0's columns zeroed and its diagonal pinned,
    damping * trace(A) / 6N + 1e-10 on the diagonal, an LU solve, and a
    step of zero unless all of it is finite.

    Returns [N, 4, 4] world-from-cloud poses, pose 0 = identity.
    """
    T_meas, edges, weights = _graph_inputs(T_meas, edges, weights)
    dev = T_meas.device
    E = T_meas.shape[0]
    T_inv = se3.inverse(T_meas)
    ii, jj = edges[:, 0], edges[:, 1]
    sqrt_w = torch.sqrt(torch.clamp_min(weights, 0.0))

    def residuals(deltas, poses, row_w):
        """[E * 6] row-weighted residuals at right-perturbed poses."""
        P = poses @ se3.exp_se3(deltas)
        r = se3.log_se3(T_inv @ se3.inverse(P[jj]) @ P[ii])
        return (row_w[:, None] * r).reshape(-1)

    warmup = max(1, iterations // 3)
    dim = 6 * n_nodes
    mask = _gauge_mask(n_nodes, dev)
    eye = torch.eye(dim, device=dev)
    zeros = torch.zeros((n_nodes, 6), device=dev)
    poses = _identity_poses(n_nodes, dev)
    for step in range(iterations):
        row_w = sqrt_w
        if robust_delta is not None and step >= warmup:
            # IRLS: the robust weights frozen at this step's residuals.
            r_raw = residuals(zeros, poses, torch.ones((E,), device=dev))
            rn2 = torch.sum(r_raw.reshape(E, 6) ** 2, dim=1)
            row_w = sqrt_w * torch.sqrt(_gm_factor(rn2, robust_delta))
        r0 = residuals(zeros, poses, row_w)
        J = torch.func.jacfwd(lambda d: residuals(d, poses, row_w))(zeros)
        J = J.reshape(E * 6, dim) * mask[None, :]
        A = J.T @ J
        A = A + (damping * torch.trace(A) / dim + 1e-10) * eye
        A = A + torch.diag(1.0 - mask)
        b = -J.T @ r0
        delta, info = torch.linalg.solve_ex(A, b)
        delta = _guarded(delta.reshape(n_nodes, 6) * mask.reshape(n_nodes, 6), info)
        poses = poses @ se3.exp_se3(delta)
    return poses


class _BlockSums:
    """Fixed-order sums of per-edge blocks into per-segment blocks.

    Contribution k goes to segment ``seg[k]`` (a node, or a pair of nodes);
    each segment adds its contributions in their order in the list, by
    elementwise adds over a [segments, rank] slab, so the sum has the same
    bits on every device and in every call (``index_add_`` on CUDA adds in
    no fixed order).  The layout depends on the edge list only and is built
    once on the host.
    """

    def __init__(self, seg: np.ndarray, dev) -> None:
        keys, inv = np.unique(seg, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        rank = np.zeros(len(inv), np.int64)
        seen = np.zeros(len(keys), np.int64)
        for k, s in enumerate(inv):
            rank[k], seen[s] = seen[s], seen[s] + 1
        self.keys = torch.as_tensor(keys, device=dev)
        self.inv = torch.as_tensor(inv, device=dev)
        self.rank = torch.as_tensor(rank, device=dev)
        self.depth = int(seen.max())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        slab = x.new_zeros((len(self.keys), self.depth) + tuple(x.shape[1:]))
        slab[self.inv, self.rank] = x
        out = slab[:, 0]
        for r in range(1, self.depth):
            out = out + slab[:, r]
        return out


def optimize_pose_graph_edgewise(
    T_meas,
    edges,
    weights,
    *,
    n_nodes: int,
    iterations: int = 20,
    damping: float = 1e-6,
    robust_delta: float | None = None,
) -> torch.Tensor:
    """``optimize_pose_graph`` with edgewise Jacobians, the scalable solve.

    Each edge's residual depends on two poses, so its exact Jacobian is
    [6, 12]: 12 forward seeds, each one ``torch.func.jvp`` of the residual
    of every edge at once (JAX: ``vmap(jacfwd)`` of one edge; an edge's
    tangent does not depend on the others).  The 6x6 blocks Hii, Hjj, Hij,
    Hji and bi, bj assemble the 6N x 6N normal equations in a fixed order
    (``_BlockSums``: JAX's order of scatter-adds), node 0 is masked out and
    pinned, damping * trace(A) / 6N + 1e-10 goes on the diagonal, and a
    Cholesky solve gives the step (zero unless finite and the factor
    succeeded).  Same semantics as ``optimize_pose_graph``.
    """
    T_meas, edges, weights = _graph_inputs(T_meas, edges, weights)
    dev = T_meas.device
    E = T_meas.shape[0]
    T_inv = se3.inverse(T_meas)
    ii, jj = edges[:, 0], edges[:, 1]
    w = torch.clamp_min(weights, 0.0)

    def edge_residual(d12, Pi, Pj):
        """[E, 6] residuals at tangent perturbations d12 = (d_i, d_j)."""
        Pi_ = Pi @ se3.exp_se3(d12[:, :6])
        Pj_ = Pj @ se3.exp_se3(d12[:, 6:])
        return se3.log_se3(T_inv @ se3.inverse(Pj_) @ Pi_)

    e_np = np.asarray(edges.cpu())
    i_np, j_np = e_np[:, 0], e_np[:, 1]
    # Contributions in JAX's scatter order: Hii, Hjj, Hij, Hji; bi, bj.
    h_sums = _BlockSums(np.stack([np.concatenate([i_np, j_np, i_np, j_np]),
                                  np.concatenate([i_np, j_np, j_np, i_np])], 1), dev)
    b_sums = _BlockSums(np.concatenate([i_np, j_np])[:, None], dev)

    warmup = max(1, iterations // 3)
    dim = 6 * n_nodes
    mask = _gauge_mask(n_nodes, dev)
    eye = torch.eye(dim, device=dev)
    zeros12 = torch.zeros((E, 12), device=dev)
    seeds = torch.eye(12, device=dev)[:, None, :].expand(12, E, 12)
    poses = _identity_poses(n_nodes, dev)
    for step in range(iterations):
        Pi, Pj = poses[ii], poses[jj]
        r0 = edge_residual(zeros12, Pi, Pj)
        Je = torch.func.vmap(
            lambda t: torch.func.jvp(lambda d: edge_residual(d, Pi, Pj), (zeros12,), (t,))[1]
        )(seeds).permute(1, 2, 0)  # [E, 6, 12]
        we = w
        if robust_delta is not None and step >= warmup:
            we = w * _gm_factor(torch.sum(r0 * r0, dim=1), robust_delta)
        Jiu, Jju = Je[:, :, :6], Je[:, :, 6:]
        Ji, Jj = Jiu * we[:, None, None], Jju * we[:, None, None]
        Hii = torch.einsum("ers,ert->est", Jiu, Ji)
        Hjj = torch.einsum("ers,ert->est", Jju, Jj)
        Hij = torch.einsum("ers,ert->est", Jiu, Jj)
        bi = -torch.einsum("ers,er->es", Ji, r0)
        bj = -torch.einsum("ers,er->es", Jj, r0)
        blocks = h_sums(torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)]))
        A = torch.zeros((n_nodes, n_nodes, 6, 6), device=dev)
        A[h_sums.keys[:, 0], h_sums.keys[:, 1]] = blocks
        A = A.transpose(1, 2).reshape(dim, dim)
        b = torch.zeros((n_nodes, 6), device=dev)
        b[b_sums.keys[:, 0]] = b_sums(torch.cat([bi, bj]))
        A = A * mask[None, :] * mask[:, None]
        A = A + (damping * torch.trace(A) / dim + 1e-10) * eye
        A = A + torch.diag(1.0 - mask)
        b = b.reshape(dim) * mask
        L, info = torch.linalg.cholesky_ex(A)
        delta = torch.cholesky_solve(b[:, None], L)[:, 0]
        delta = _guarded(delta.reshape(n_nodes, 6) * mask.reshape(n_nodes, 6), info)
        poses = poses @ se3.exp_se3(delta)
    return poses


def _solve_pose_graph(T_meas, e_arr, w_arr, *, n_nodes, iterations, robust_delta=None):
    fn = optimize_pose_graph_edgewise if n_nodes >= _EDGEWISE_THRESHOLD else optimize_pose_graph
    return fn(T_meas, e_arr, w_arr, n_nodes=n_nodes, iterations=iterations,
              robust_delta=robust_delta)


@dataclasses.dataclass
class MultiwayResult:
    poses: np.ndarray  # [N, 4, 4] world-from-cloud
    edges: np.ndarray  # [E, 2]
    edge_transforms: np.ndarray  # [E, 4, 4]
    edge_fitness: np.ndarray  # [E]


def default_edges(n: int, loop_closure: bool = True) -> list[tuple[int, int]]:
    """Chain 0-1-2-...-(n-1) plus the closing edge (n-1, 0)."""
    edges = [(i, i + 1) for i in range(n - 1)]
    if loop_closure and n > 2:
        edges.append((n - 1, 0))
    return edges


def _start(clouds, config, edges, checkpoint_dir):
    """(n, edges, config, store) with JAX's defaults; the manifest written."""
    n = len(clouds)
    if n < 2:
        raise ValueError("multiway registration needs >= 2 clouds")
    if edges is None:
        edges = default_edges(n)
    if config is None:
        config = PipelineConfig.with_voxel_size(clouds[0].voxel_size)
    store = None
    if checkpoint_dir is not None:
        store = CheckpointStore(checkpoint_dir)
        store.write_manifest(n_clouds=n, edges=[list(e) for e in edges],
                             voxel_size=float(clouds[0].voxel_size))
    return n, edges, config, store


def _checked_edge_bits(edge_bits, n_edges: int):
    if edge_bits is not None and len(edge_bits) != n_edges:
        raise ValueError(f"edge_bits has {len(edge_bits)} rows for {n_edges} edges")
    return edge_bits


def register_multiway(
    clouds,
    config: PipelineConfig | None = None,
    *,
    edges: list[tuple[int, int]] | None = None,
    generator: torch.Generator | None = None,
    edge_bits=None,
    pose_graph_iters: int = 20,
    checkpoint_dir: str | None = None,
    robust_delta: float | None = None,
    device=None,
) -> MultiwayResult:
    """Align N preprocessed clouds into one frame: ``register_pair`` along
    the edge list (RANSAC on the down clouds, ICP at full resolution), then
    the pose-graph solve.

    ``clouds`` are ProcessedClouds whose down and full clouds both lie on
    ``device`` (CUDA when None; raises without it): the full-resolution ICP
    needs the full clouds' normals, so clouds from
    ``preprocess_points_batch(full_normals=False)`` (host full clouds) are
    refused.  Edge e's RANSAC takes ``edge_bits[e]`` (``register_pair``'s
    ``sample_bits``), else a generator seeded from ``generator`` (one draw
    an edge, seeded 0 when None).  With ``checkpoint_dir`` each completed
    edge is persisted and skipped on a re-run; the poses go to
    ``poses.npz``.
    """
    from tpu3dm_torch.registration.pipeline import register_pair

    dev = resolve_device(device)
    n, edges, config, store = _start(clouds, config, edges, checkpoint_dir)
    edge_bits = _checked_edge_bits(edge_bits, len(edges))
    for k, c in enumerate(clouds):
        where = {c.down.points.device, c.full.points.device}
        if not all(d.type == dev.type and dev.index in (None, d.index) for d in where):
            raise ValueError(
                f"register_multiway: cloud {k} lies on {sorted(map(str, where))}, not {dev}; "
                "the full-resolution ICP needs full clouds with normals on the run's device "
                "(preprocess_points_batch(..., full_normals=True, device=...))")
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    T_list, fit_list = [], []
    for e, (i, j) in enumerate(edges):
        # One draw an edge whether or not it is cached, so a resumed run
        # reproduces the bits of an uninterrupted one.
        seed = int(torch.randint(0, 1 << 62, (1,), generator=generator))
        rec = store.get_edge(i, j) if store is not None else None
        if rec is not None:
            T_list.append(np.asarray(rec.transformation, np.float32))
            fit_list.append(rec.fitness)
            continue
        bits = None if edge_bits is None else torch.as_tensor(edge_bits[e])
        out = register_pair(clouds[i], clouds[j], config, sample_bits=bits,
                            generator=torch.Generator().manual_seed(seed))
        T = out.transformation.cpu().numpy()
        T_list.append(T)
        fit_list.append(float(out.icp.fitness))
        if store is not None:
            store.put_edge(i, j, EdgeRecord(
                transformation=T, fitness=float(out.icp.fitness),
                inlier_rmse=float(out.icp.inlier_rmse), iterations=int(out.icp.iterations)))
    return _solve_poses(n, edges, T_list, fit_list, pose_graph_iters, store, robust_delta, dev)


def register_multiway_batched(
    clouds,
    config: PipelineConfig | None = None,
    *,
    edges: list[tuple[int, int]] | None = None,
    generator: torch.Generator | None = None,
    edge_bits=None,
    pose_graph_iters: int = 20,
    ransac_iterations: int = 4096,
    icp_iterations: int = 12,
    icp_solves_per_nn: int = 2,
    approx_score: bool = True,
    rescue_restarts: int | None = None,
    mesh=None,
    checkpoint_dir: str | None = None,
    robust_delta: float | None = None,
    device=None,
) -> MultiwayResult:
    """Align N preprocessed clouds, every edge through ``fused_register_step``.

    The down clouds are stacked to the largest capacity on ``device`` (CUDA
    when None; raises without it); the edge axis runs in chunks of
    min(128, E) edges, the last padded with repeats of edge 0 and its bits
    (a pair's result does not depend on its batch, so the padding changes
    no edge).  Knobs as JAX's: ``ransac_batch = min(ransac_iterations,
    4096)``, the config's thresholds and mutual filter, ``rescue_restarts``
    from the config when None.  Edge e takes ``edge_bits[e]`` (shape
    ``batch.pair_bits_shape(cap, ransac_iterations=..., rescue_restarts=...)
    [0]``), else bits drawn edge after edge from ``generator`` (seeded 0
    when None).  The full clouds are never read.

    Checkpointing is batch-granular, as JAX's: when every edge is stored the
    stored edges are reused, otherwise every edge is registered and stored.
    ``mesh``: a ``parallel.mesh.Mesh``; the chunk width is rounded up to a
    multiple of its pair axis (JAX's quantum), each chunk's edges and bits
    are split over that axis, and the edges' results equal the call without
    a mesh, bit for bit.
    """
    from tpu3dm_torch.registration.batch import pair_bits_shape
    from tpu3dm_torch.registration.fused import fused_register_step

    if mesh is not None:
        check_mesh("register_multiway_batched", mesh)
    dev = resolve_device(device)
    n, edges, config, store = _start(clouds, config, edges, checkpoint_dir)
    edge_bits = _checked_edge_bits(edge_bits, len(edges))
    if store is not None:
        cached = [store.get_edge(*e) for e in edges]
        if all(rec is not None for rec in cached):
            return _solve_poses(
                n, edges, [np.asarray(r.transformation, np.float32) for r in cached],
                [r.fitness for r in cached], pose_graph_iters, store, robust_delta, dev)

    cap = max(c.down.capacity for c in clouds)

    def stacked(attr):
        rows = [getattr(c.down, attr).to(dev) for c in clouds]
        return torch.stack([torch.cat([x, x.new_zeros((cap - x.shape[0],) + x.shape[1:])])
                            for x in rows])

    pts, feat, msk, nrm = (stacked(a) for a in ("points", "features", "mask", "normals"))
    if rescue_restarts is None:
        rescue_restarts = config.ransac.rescue_restarts
    n_edges = len(edges)
    if edge_bits is None:
        shape = pair_bits_shape(cap, ransac_iterations=ransac_iterations,
                                rescue_restarts=rescue_restarts)[0]
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        edge_bits = [draw_bits(shape, gen) for _ in range(n_edges)]
    bits = torch.stack([torch.as_tensor(b) for b in edge_bits])
    e_np = np.asarray(edges, np.int64)
    # Chunks of equal width, padded with repeats of edge 0 (and its bits) to
    # a multiple of the mesh's pair axis; padded lanes are sliced off.
    quantum = mesh.shape[PAIR_AXIS] if mesh is not None else 1
    chunk_w = round_up(min(EDGE_CHUNK, round_up(n_edges, quantum)), quantum)
    e_pad = -(-n_edges // chunk_w) * chunk_w
    if e_pad > n_edges:
        e_np = np.concatenate([e_np, np.repeat(e_np[:1], e_pad - n_edges, 0)])
        bits = torch.cat([bits, bits[:1].expand((e_pad - n_edges,) + bits.shape[1:])])
    si = torch.as_tensor(e_np[:, 0], device=dev)
    ti = torch.as_tensor(e_np[:, 1], device=dev)

    def run(d, s, t, b):
        """The fused step over edges (s, t) with bits b on device d."""
        p_, f_, m_, n_ = (x.to(d) for x in (pts, feat, msk, nrm))
        s, t = s.to(d), t.to(d)
        return fused_register_step(
            p_[s], f_[s], m_[s], None, p_[t], f_[t], m_[t], n_[t], b, device=d,
            dist_thresh=config.ransac.dist_thresh, icp_thresh=config.icp.dist_thresh,
            ransac_iterations=ransac_iterations, ransac_batch=min(ransac_iterations, 4096),
            icp_iterations=icp_iterations, icp_solves_per_nn=icp_solves_per_nn,
            approx_score=approx_score, mutual_filter=config.ransac.mutual_filter,
            rescue_restarts=rescue_restarts)

    outs = []
    for lo in range(0, e_pad, chunk_w):
        chunk = (si[lo:lo + chunk_w], ti[lo:lo + chunk_w], bits[lo:lo + chunk_w])
        if mesh is None:
            outs.append(run(dev, *chunk))
        else:
            outs.append(map_shards(mesh.line(PAIR_AXIS), run, *chunk, out=3))
    T_np, fit_np, rmse_np = (torch.cat([o[k] for o in outs])[:n_edges].cpu().numpy()
                             for k in range(3))
    T_list = list(T_np)
    fit_list = [float(f) for f in fit_np]
    if store is not None:
        for e, (i, j) in enumerate(edges):
            store.put_edge(i, j, EdgeRecord(transformation=T_list[e], fitness=fit_list[e],
                                            inlier_rmse=float(rmse_np[e]),
                                            iterations=ransac_iterations))
    return _solve_poses(n, edges, T_list, fit_list, pose_graph_iters, store, robust_delta, dev)


def _solve_poses(n, edges, T_list, fit_list, pose_graph_iters, store, robust_delta, dev):
    T_meas = torch.as_tensor(np.stack(T_list), dtype=torch.float32, device=dev)
    w = torch.as_tensor(np.asarray(fit_list, np.float32), device=dev)
    poses = _solve_pose_graph(T_meas, edges, w, n_nodes=n, iterations=pose_graph_iters,
                              robust_delta=robust_delta).cpu().numpy()
    if store is not None:
        store.write_poses(poses)
    return MultiwayResult(poses=poses, edges=np.asarray(edges),
                          edge_transforms=np.stack(T_list), edge_fitness=np.asarray(fit_list))
