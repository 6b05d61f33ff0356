"""Ring nearest-neighbour search over the block axis (port of tpu3dm/parallel/ring_nn.py).

Query and target rows are sharded over the mesh's ``block`` axis.  Each of
the nb steps searches every resident query shard against the target shard
it holds (``ops.nn.nn_search``: dense up to 16M entries a step, the tiled
kernels csrc/nn_tiled.cu above on CUDA), folds a running (d2, global index)
with ties to the smaller global index, and shifts the target shards one
position around the ring.

Exactness: a fold of per-shard first minima with the smaller-index tie
break is the first minimum of the whole row, so the ring returns the whole
search's result wherever a shard's per-element distances equal the whole
search's.  At d = 3 they do (both dense and kernel 4 compute the direct
sum of squared differences); at d >= 8 the distance comes from a
``|t|^2 - 2 q.t`` product whose last bits may follow the matrix shape, so
distances agree to fp32 rounding and an index may differ on a near-tie.
"""

from __future__ import annotations

import functools

import torch

from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.parallel.mesh import BLOCK_AXIS, Mesh


def ring_nn_search(
    mesh: Mesh,
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor,
    target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-1 NN with query AND target sharded over the block axis.

    Args:
      mesh: a mesh whose ``block`` axis has size nb.
      query: [Nq, D], target: [Nt, D] float32, Nq and Nt multiples of nb.
      query_mask / target_mask: [Nq] / [Nt] bool.  As in JAX, the per-step
        search takes no query mask: masked queries get a result too.

    Returns (d2 [Nq], idx [Nq] int32, global into target) on the mesh's
    home device.
    """
    line = mesh.line(BLOCK_AXIS)
    nb = line.n
    shard_nt = target.shape[0] // nb
    del query_mask  # JAX shards it, and its per-step search ignores it
    qs = line.split(query)
    ts, tms = line.split(target), line.split(target_mask)
    best_d2, best_idx = [None] * nb, [None] * nb
    for i in line.local():
        n = qs[i].shape[0]
        best_d2[i] = torch.full((n,), 1e30, dtype=torch.float32, device=line.devices[i])
        best_idx[i] = torch.zeros((n,), dtype=torch.int32, device=line.devices[i])
    src_dev = list(range(nb))  # the origin of the target shard each position holds
    for _ in range(nb):
        for i in line.local():
            d2, idx = nn_search(qs[i], ts[i], None, tms[i])
            idx_g = idx + src_dev[i] * shard_nt
            # Ties to the smaller global index: the single-device result
            # whatever the visit order.
            better = (d2 < best_d2[i]) | ((d2 == best_d2[i]) & (idx_g < best_idx[i]))
            best_d2[i] = torch.where(better, d2, best_d2[i])
            best_idx[i] = torch.where(better, idx_g, best_idx[i])
        ts, tms = line.shift(ts), line.shift(tms)
        src_dev = src_dev[-1:] + src_dev[:-1]
    return line.concat(best_d2), line.concat(best_idx)


def ring_nn_jit(mesh: Mesh):
    """``ring_nn_search`` bound to a mesh (JAX's jitted convenience; eager
    PyTorch has nothing to compile)."""
    return functools.partial(ring_nn_search, mesh)
