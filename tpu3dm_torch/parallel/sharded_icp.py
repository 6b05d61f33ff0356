"""Sharded large-cloud ICP over the block axis (port of tpu3dm/parallel/sharded_icp.py).

Both clouds are split over the mesh's ``block`` axis.  Each ICP iteration:

  1. every position moves its resident source shard by the replicated T;
  2. ring correspondence search: target shards (with their normals and
     mask) shift one position around the ring nb - 1 times while each
     position folds a running (d2, target point, target normal) for its
     source shard, ties to the smaller global target index;
  3. each position assembles its local 6x6 normal equations (point-to-plane,
     or the 3N x 6 point-to-point system); the ordered sum over the block
     axis (``Line.psum``: position order, one device) gives A and b;
  4. the damped 6x6 solve and the SE(3) update run once on the mesh's home
     device, so T is the same bits on every position.

Each ring step searches with ``ops.nn.nn_search`` (the dense ring: the tiled
kernel csrc/nn_tiled.cu on CUDA above 16M entries a step) or, with
``block_sparse``, with ``ops.nn_sparse.nn_blocksparse`` over KD-sorted
shards (csrc/nn_blocksparse.cu).  Convergence is Open3D's absolute-delta
test on fitness and RMSE, read on the host once an iteration; the last
correspondence pass gives the returned fitness and RMSE.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dm_torch.core import se3
from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.ops.nn_sparse import SPARSE_PAD, kd_perm, nn_blocksparse
from tpu3dm_torch.parallel.mesh import BLOCK_AXIS, Line, Mesh
from tpu3dm_torch.parallel.multipair import f32_square
from tpu3dm_torch.registration.result import RegistrationResult

_BIG = 1.0e30
_INT32_MAX = 2**31 - 1


def _pad_shards(arr: np.ndarray, nb: int) -> np.ndarray:
    """Zero-pad axis 0 to a multiple of nb (host, once a cloud)."""
    pad = (-arr.shape[0]) % nb
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)


def _prep_blocksparse_shards(
    points: np.ndarray,
    normals: np.ndarray | None,
    nb: int,
    block: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Two-level spatial partition for the block-sparse ring (host, once).

    The cloud is KD-partitioned into nb spatially compact shards (tight
    per-block boxes when a shard visits another position), each shard is
    KD-sorted at ``block`` granularity (nn_blocksparse's contract) and padded
    to one common block-multiple length with SPARSE_PAD rows.

    Returns (points [nb * pad_len, 3], mask [nb * pad_len], normals or None).
    """
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    shard_size = -(-n // nb)
    outer = kd_perm(pts, shard_size)
    pts_o = pts[outer]
    nrm_o = np.asarray(normals, np.float32)[outer] if normals is not None else None
    pad_len = ((shard_size + block - 1) // block) * block
    out_p = np.full((nb * pad_len, 3), SPARSE_PAD, np.float32)
    out_m = np.zeros((nb * pad_len,), bool)
    out_n = np.zeros((nb * pad_len, 3), np.float32) if normals is not None else None
    for s in range(nb):
        lo, hi = s * shard_size, min((s + 1) * shard_size, n)
        sh = pts_o[lo:hi]
        if sh.shape[0] == 0:
            continue
        inner = kd_perm(sh, block)
        dst = s * pad_len
        out_p[dst:dst + sh.shape[0]] = sh[inner]
        out_m[dst:dst + sh.shape[0]] = True
        if out_n is not None:
            out_n[dst:dst + sh.shape[0]] = nrm_o[lo:hi][inner]
    return out_p, out_m, out_n


class _Ring:
    """The resident shards of one sharded ICP and its correspondence pass."""

    def __init__(self, line: Line, src, smask, tgt, tnrm, tmask, *, thresh_sq: float,
                 block_sparse: bool, block: int, w: int) -> None:
        self.line = line
        self.src, self.smask = line.split(src), line.split(smask)
        self.tgt, self.tnrm, self.tmask = line.split(tgt), line.split(tnrm), line.split(tmask)
        self.shard_nt = tgt.shape[0] // line.n
        self.thresh_sq = thresh_sq
        self.block_sparse, self.block, self.w = block_sparse, block, w
        n_src = line.psum(self.each(lambda i: torch.sum(self.smask[i].to(torch.float32))))
        self.denom = torch.clamp_min(n_src, 1.0)

    def each(self, fn) -> list:
        """[fn(i) at each local position, None elsewhere]."""
        out: list = [None] * self.line.n
        for i in self.line.local():
            out[i] = fn(i)
        return out

    def correspond(self, T: torch.Tensor):
        """(moved source shards, matched points, matched normals, inlier
        masks, fitness, RMSE): lists by position, then two scalars."""
        line = self.line
        Ts = line.replicate(T)
        # Masked source rows keep their pad coordinates (T would move them):
        # zeros on the dense ring, SPARSE_PAD sentinels on the block-sparse one.
        pts = self.each(lambda i: torch.where(
            self.smask[i][:, None], se3.apply(Ts[i], self.src[i]), self.src[i]).contiguous())
        bd2 = self.each(lambda i: torch.full((pts[i].shape[0],), _BIG, device=pts[i].device))
        bq = self.each(lambda i: torch.zeros_like(pts[i]))
        bn = self.each(lambda i: torch.zeros_like(pts[i]))
        bidx = self.each(lambda i: torch.full((pts[i].shape[0],), _INT32_MAX,
                                                dtype=torch.int32, device=pts[i].device))
        t_blk, n_blk, m_blk = self.tgt, self.tnrm, self.tmask
        src_dev = list(range(line.n))
        for step in range(line.n):
            for i in line.local():
                if self.block_sparse:
                    # Sentinel rows never win; a masked match fails d2 < thresh^2.
                    d2, idx, _ = nn_blocksparse(pts[i], t_blk[i], block=self.block, w=self.w)
                else:
                    d2, idx = nn_search(pts[i], t_blk[i], None, m_blk[i])
                gidx = idx + src_dev[i] * self.shard_nt
                better = (d2 < bd2[i]) | ((d2 == bd2[i]) & (gidx < bidx[i]))
                il = idx.to(torch.int64)
                bd2[i] = torch.where(better, d2, bd2[i])
                bq[i] = torch.where(better[:, None], t_blk[i][il], bq[i])
                bn[i] = torch.where(better[:, None], n_blk[i][il], bn[i])
                bidx[i] = torch.where(better, gidx, bidx[i])
            if step < line.n - 1:  # the last shift would only bring the shards home
                t_blk, n_blk, m_blk = line.shift(t_blk), line.shift(n_blk), line.shift(m_blk)
                src_dev = src_dev[-1:] + src_dev[:-1]
        m = self.each(lambda i: (bd2[i] < self.thresh_sq) & self.smask[i])
        # Global fitness and inlier RMSE (Open3D's RegistrationResult).
        inl = line.psum(self.each(lambda i: torch.sum(m[i].to(torch.float32))))
        err = line.psum(self.each(lambda i: torch.sum(torch.where(m[i], bd2[i], 0.0))))
        return pts, bq, bn, m, inl / self.denom, torch.sqrt(err / torch.clamp_min(inl, 1.0))


def _normal_equations(pts, q, nrm, m, point_to_plane: bool):
    """Local (A [6, 6], b [6]) of one source shard; rows outside ``m`` are
    zeroed before any product (the weights are 0 / 1), so pad rows cannot
    overflow into the sum."""
    wgt = m.to(torch.float32)
    if point_to_plane:
        r = torch.sum((pts - q) * nrm, dim=1)
        J = torch.cat([nrm, torch.cross(pts, nrm, dim=1)], dim=1)
    else:
        eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(pts.shape[0], 3, 3)
        J = torch.cat([eye, -se3.hat(pts)], dim=2).reshape(-1, 6)
        r = (pts - q).reshape(-1)
        wgt = torch.repeat_interleave(wgt, 3)
    J = J * wgt[:, None]
    r = r * wgt
    return torch.einsum("ni,nj->ij", J, J), -torch.einsum("ni,n->i", J, r)


def _icp_sharded(mesh: Mesh, src, smask, tgt, tnrm, tmask, init_T, *, dist_thresh: float,
                 relative_fitness: float, relative_rmse: float, max_iterations: int,
                 point_to_plane: bool, block_sparse: bool, block: int,
                 w: int) -> RegistrationResult:
    line = mesh.line(BLOCK_AXIS)
    ring = _Ring(line, src, smask, tgt, tnrm, tmask, thresh_sq=f32_square(dist_thresh),
                 block_sparse=block_sparse, block=block, w=w)
    home = mesh.home
    eye6 = torch.eye(6, dtype=torch.float32, device=home)

    def solve_step(T):
        pts, q, nrm, m, fitness, rmse = ring.correspond(T)
        parts = ring.each(lambda i: _normal_equations(pts[i], q[i], nrm[i], m[i],
                                                        point_to_plane))
        A = line.psum([None if p is None else p[0] for p in parts])
        b = line.psum([None if p is None else p[1] for p in parts])
        A = A + 1e-6 * torch.trace(A) / 6.0 * eye6 + 1e-12 * eye6
        # solve_ex: a singular system reports in info instead of raising; the
        # guard zeroes the step on the device, as JAX's all-finite guard.
        xi, info = torch.linalg.solve_ex(A, b)
        xi = torch.where(torch.all(torch.isfinite(xi)) & (info == 0), xi, 0.0)
        return se3.exp_se3(xi) @ T, fitness, rmse

    T = torch.as_tensor(init_T, dtype=torch.float32).to(home)
    f_cur = r_cur = torch.tensor(-1.0, dtype=torch.float32, device=home)
    it = 0
    while it < max_iterations:
        T_new, f_new, r_new = solve_step(T)
        # Absolute deltas: Open3D's ICPConvergenceCriteria compares absolute
        # changes despite its "relative_*" names (registration/icp.py).
        done = it > 0 and bool((torch.abs(f_new - f_cur) < relative_fitness)
                               & (torch.abs(r_new - r_cur) < relative_rmse))
        it += 1
        T, f_cur, r_cur = T_new, f_new, r_new
        if done:
            break
    *_, fitness, rmse = ring.correspond(T)
    return RegistrationResult(transformation=T, fitness=fitness, inlier_rmse=rmse,
                              iterations=torch.tensor(it, dtype=torch.int32))


def icp_refine_sharded(
    mesh: Mesh,
    src_pts,
    tgt_pts,
    init_T,
    *,
    tgt_normals=None,
    dist_thresh: float,
    max_iterations: int = 30,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    point_to_plane: bool | None = None,
    block_sparse: bool = False,
    block: int = 512,
    w: int = 8,
) -> RegistrationResult:
    """ICP refinement with both clouds sharded over the mesh's block axis.

    Pads each cloud to a multiple of the block axis (masks track the true
    counts), places the shards and runs the loop.  Semantics (metrics,
    convergence, thresholds) match ``registration.icp.icp_refine`` and
    ``registration.large.icp_refine_large``.

    The dense ring pads with zeros, not a huge sentinel: a 1e30 coordinate
    makes the -2 q.t cross term comparable to the masking bias, so a pad row
    could win with a clamped d2 = 0.  ``block_sparse=True`` searches only w
    KD-blocked candidate blocks a ring step (two-level partition, SPARSE_PAD
    pads): candidate-bounded, not certified exact, and a long non-exact match
    fails the d2 < thresh^2 test.

    Args:
      mesh: a mesh with a ``block`` axis (the pair axis is untouched).
      src_pts / tgt_pts: [N, 3] arrays (NumPy or tensors).
      tgt_normals: [Nt, 3]; point-to-plane (the default when given) needs them.
    Returns the RegistrationResult on the mesh's home device.
    """
    if point_to_plane is None:
        point_to_plane = tgt_normals is not None
    if point_to_plane and tgt_normals is None:
        raise ValueError("point_to_plane ICP needs target normals")
    nb = mesh.shape[BLOCK_AXIS]

    def host(x):
        return np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32)

    src_np, tgt_np = host(src_pts), host(tgt_pts)
    nrm_np = None if tgt_normals is None else host(tgt_normals)
    ns, nt = src_np.shape[0], tgt_np.shape[0]
    if block_sparse:
        src_p, smask, _ = _prep_blocksparse_shards(src_np, None, nb, block)
        tgt_p, tmask, nrm_p = _prep_blocksparse_shards(tgt_np, nrm_np, nb, block)
        if nrm_p is None:
            nrm_p = np.zeros_like(tgt_p)
    else:
        src_p = _pad_shards(src_np, nb)
        tgt_p = _pad_shards(tgt_np, nb)
        smask = np.arange(src_p.shape[0]) < ns
        tmask = np.arange(tgt_p.shape[0]) < nt
        nrm_p = _pad_shards(nrm_np, nb) if nrm_np is not None else np.zeros_like(tgt_p)
    return _icp_sharded(
        mesh, *(torch.from_numpy(np.array(a)) for a in (src_p, smask, tgt_p, nrm_p, tmask)),
        init_T, dist_thresh=dist_thresh, relative_fitness=relative_fitness,
        relative_rmse=relative_rmse, max_iterations=max_iterations,
        point_to_plane=point_to_plane, block_sparse=block_sparse, block=block, w=w,
    )
