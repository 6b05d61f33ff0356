"""Block-sparse nearest-neighbour search for large clouds (port of tpu3dm/ops/nn_sparse.py).

Both clouds are KD-partitioned on the host (``kd_perm``: the JAX package's
native C++ partition, copied into csrc/host.cpp) and padded to a block multiple with far-away
sentinel rows (``pad_sorted``).  ``candidate_blocks`` ranks, for each query
block, the target blocks by box-to-box distance (plain PyTorch, as it was
XLA in JAX) and keeps the w best with an exactness certificate.  The search
over those candidates is ``nn_search_table``: on CUDA it launches
csrc/nn_blocksparse.cu, which replaces ``_sparse_nn_kernel``; on the CPU it
runs ``nn_search_table_plain``, the same arithmetic chunked over query blocks.
``morton_perm`` (a Z-order sort, host NumPy) is a copy of JAX's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu3dm_torch.csrc import (
    INT,
    PTR,
    Kernel,
    check_cuda_tensors,
    check_dtype,
    dispatch,
    host_library,
)
from tpu3dm_torch.ops.nn import lane_slices

# Padding sentinel: far enough that padded rows never win a min, small enough
# that squared distances stay inside float32.
SPARSE_PAD = 1.0e6

NN_BLOCKSPARSE = Kernel(
    "nn_blocksparse", "nn_blocksparse.cu", "t3t_nn_blocksparse", [PTR] * 5 + [INT] * 3,
)
MAX_BLOCK = 2048  # the largest block the card tests hold the kernel to


def morton_perm(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Permutation sorting points along a 3-D Morton (Z-order) curve with
    2^bits cells per axis (host NumPy, a copy of JAX's)."""
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    span = np.maximum(pts.max(axis=0) - lo, 1e-12)
    q = np.minimum(((pts - lo) / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)

    def spread(x):
        # interleave bits: two zero bits between each bit of x
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def kd_perm(points: np.ndarray, block: int) -> np.ndarray:
    """Permutation grouping points into KD-partition leaves of at most
    ``block`` points: recursive widest-axis median split, threaded, on the
    host (``t3n_kd_perm`` of csrc/host.cpp, the JAX package's native
    partition, which its ``kd_perm`` calls whenever that tier is built).
    """
    pts = np.ascontiguousarray(points, dtype=np.float64)
    out = np.empty(pts.shape[0], dtype=np.int64)
    host_library().t3n_kd_perm(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), pts.shape[0], int(block),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return out


def pad_sorted(points: np.ndarray, block: int) -> np.ndarray:
    """Pad a sorted cloud to a block multiple with far-away sentinel rows."""
    n = points.shape[0]
    pad = (-n) % block
    if pad == 0:
        return np.asarray(points, np.float32)
    return np.concatenate(
        [points, np.full((pad, 3), SPARSE_PAD, points.dtype)], axis=0
    ).astype(np.float32)


def _block_bounds(points: torch.Tensor, block: int):
    """Per-block AABB (lo, hi [nb, 3]) and centroid [nb, 3], sentinel-aware."""
    nb = points.shape[0] // block
    pb = points.reshape(nb, block, 3)
    valid = pb[:, :, 0] < SPARSE_PAD * 0.5
    v3 = valid[:, :, None]
    lo = torch.amin(torch.where(v3, pb, 3.0e38), dim=1)
    hi = torch.amax(torch.where(v3, pb, -3.0e38), dim=1)
    cnt = torch.clamp_min(torch.sum(valid, dim=1), 1)
    cen = torch.sum(torch.where(v3, pb, 0.0), dim=1) / cnt[:, None]
    return lo, hi, cen


def candidate_blocks(
    query: torch.Tensor, target: torch.Tensor, block: int, w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx [nqb, w] int32, cert_lb [nqb] float32).

    idx: the w best target blocks per query block, ranked by box-to-box
    distance, ties among touching boxes broken by centroid distance.
    cert_lb: the least box-to-box distance over the UNVISITED blocks; a query
    of block i whose found neighbour has sqrt(d2) <= cert_lb[i] provably has
    its true nearest neighbour among the visited blocks.

    JAX picks the w blocks by w rounds of first-occurrence argmin; a stable
    ascending sort gives the same blocks in the same order.
    """
    qlo, qhi, qc = _block_bounds(query, block)
    tlo, thi, tc = _block_bounds(target, block)
    gap = torch.clamp_min(
        torch.maximum(qlo[:, None, :] - thi[None, :, :], tlo[None, :, :] - qhi[:, None, :]),
        0.0,
    )  # [nqb, ntb, 3]
    aabb = torch.sqrt(torch.sum(gap * gap, dim=-1))
    cdist = torch.sqrt(torch.clamp_min(
        torch.sum(qc * qc, 1)[:, None] + torch.sum(tc * tc, 1)[None, :] - 2.0 * (qc @ tc.T),
        0.0,
    ))
    sel = aabb * 1024.0 + cdist
    idx = torch.sort(sel, dim=1, stable=True).indices[:, :w]
    cert_lb = torch.amin(aabb.scatter(1, idx, 3.0e38), dim=1)
    return idx.to(torch.int32).contiguous(), cert_lb


def nn_search_table_plain(query, target, table, *, block: int):
    """Plain PyTorch version of ``nn_search_table`` (any device), chunked over
    query blocks so the [c, block, w * block] distances stay under 256 MB.

    Same arithmetic and order as the kernel: p = tsq - 2 ((q0 t0 + q1 t1) +
    q2 t2), each step rounded on its own; the first argmin over the visits
    in rank order, rows in order; then + |q|^2 and max(., 0).
    """
    nqb, w = table.shape
    ntb = target.shape[0] // block
    tsq = torch.sum(target * target, dim=-1)
    tb = target.reshape(ntb, block, 3)
    tsqb = tsq.reshape(ntb, block)
    qb_all = query.reshape(nqb, block, 3)
    tab = table.to(torch.int64)
    parts, idxs = [], []
    for s in lane_slices(nqb, block * w * block):
        cand = tb[tab[s]].reshape(-1, 1, w * block, 3)
        ctsq = tsqb[tab[s]].reshape(-1, 1, w * block)
        qb = qb_all[s][:, :, None, :]
        cross = qb[..., 0] * cand[..., 0] + qb[..., 1] * cand[..., 1] + qb[..., 2] * cand[..., 2]
        p = ctsq - 2.0 * cross  # [c, block, w * block]
        within = torch.argmin(p, dim=-1)
        parts.append(torch.amin(p, dim=-1).reshape(-1))
        gidx = torch.gather(tab[s], 1, within // block) * block + within % block
        idxs.append(gidx.reshape(-1))
    part = torch.cat(parts)
    qsq = torch.sum(query * query, dim=-1)
    return torch.clamp_min(part + qsq, 0.0), torch.cat(idxs).to(torch.int32)


def nn_search_table(
    query: torch.Tensor, target: torch.Tensor, table: torch.Tensor, *, block: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN of each query among the target blocks its block visits.

    Args:
      query: [nqb * block, 3] float32, target: [ntb * block, 3] float32, both
        KD-sorted and padded (``pad_sorted``).
      table: [nqb, w] int32, the visits of each query block in rank order
        (``candidate_blocks``).

    Returns (d2 [Nq] float32, idx [Nq] int32 into the sorted target).  Ties go
    to the first row of a block and to the earlier-ranked block.
    """
    where = "nn_search_table"
    if query.ndim != 2 or target.ndim != 2 or query.shape[1] != 3 or target.shape[1] != 3:
        raise ValueError(f"{where}: expected [Nq, 3] and [Nt, 3], got "
                         f"{tuple(query.shape)} and {tuple(target.shape)}")
    if query.shape[0] % block or target.shape[0] % block:
        raise ValueError(f"{where}: both clouds must be padded to a multiple of {block} (pad_sorted)")
    if table.ndim != 2 or table.shape[0] != query.shape[0] // block:
        raise ValueError(f"{where}: table must be [{query.shape[0] // block}, w], "
                         f"got {tuple(table.shape)}")
    if dispatch(where, query, target, table) == "cpu":
        return nn_search_table_plain(query, target, table, block=block)
    if block > MAX_BLOCK:
        raise NotImplementedError(f"{where}: the kernel is held to block <= {MAX_BLOCK}, "
                                  f"got {block}")
    check_dtype(where, torch.float32, query=query, target=target)
    check_dtype(where, torch.int32, table=table)
    nq = query.shape[0]
    nqb, w = table.shape
    t4 = torch.cat([target, torch.sum(target * target, dim=-1)[:, None]], dim=1)
    part = torch.empty((nq,), dtype=torch.float32, device=query.device)
    idx = torch.empty((nq,), dtype=torch.int32, device=query.device)
    dev = check_cuda_tensors(where, 1, query=query, t4=t4, table=table, part=part, idx=idx)
    NN_BLOCKSPARSE.launch(
        dev, query.data_ptr(), t4.data_ptr(), table.data_ptr(),
        part.data_ptr(), idx.data_ptr(), nqb, block, w,
    )
    return torch.clamp_min(part + torch.sum(query * query, dim=-1), 0.0), idx


def nn_search_blocksparse(
    query: torch.Tensor,
    target: torch.Tensor,
    *,
    block: int = 512,
    w: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 NN visiting only w candidate target blocks per query block.

    Both clouds must be KD-sorted and padded to a block multiple with
    SPARSE_PAD rows (``pad_sorted``).  Returns (d2 [Nq], idx [Nq] into the
    sorted target, cert_lb [nqb]).
    """
    nq, nt = query.shape[0], target.shape[0]
    if nq % block or nt % block:
        raise ValueError(f"nn_search_blocksparse: pad both clouds to a multiple of {block}")
    w = min(w, nt // block)
    table, cert_lb = candidate_blocks(query, target, block, w)
    d2, idx = nn_search_table(query, target, table, block=block)
    return d2, idx, cert_lb


# The JAX package's backend-dispatching name; here the tensors' device picks
# the kernel or its plain version.
nn_blocksparse = nn_search_blocksparse
