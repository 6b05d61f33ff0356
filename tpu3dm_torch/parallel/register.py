"""Mesh-sharded batched registration (port of tpu3dm/parallel/register.py).

A batch of preprocessed pairs, stacked to one capacity, is split over the
mesh's ``pair`` axis, and each shard runs the complete fused step
(registration/fused.py: correspondences -> RANSAC -> ICP) on its device
with JAX's knobs (``ransac_batch = min(ransac_iterations, 4096)``, the
step's defaults otherwise).  This is the unit the scaling benchmark
measures at mesh sizes 1..N.

Deterministic: each pair takes its own bits, split with it, and the fused
step's sums do not follow the batch size (ops/rowsum.py), so a pair's
result is the same bits on any mesh.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.parallel.mesh import PAIR_AXIS, Mesh, map_shards
from tpu3dm_torch.parallel.multipair import extra_chunk_count
from tpu3dm_torch.registration.fused import fused_register_step


def batched_register(
    mesh: Mesh,
    src_pts,
    src_feat,
    src_mask,
    src_normals,
    tgt_pts,
    tgt_feat,
    tgt_mask,
    tgt_normals,
    sample_bits: torch.Tensor,
    *,
    extra_bits: torch.Tensor | None = None,
    dist_thresh: float = 0.45,
    icp_thresh: float = 0.12,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 1,
    approx_score: bool = False,
    rescue_restarts: int = 0,
    verify_iters: int = 8,
    score_subset: int = 0,
    rescore_top: int = 128,
    sample_mode: str = "roll",
    adapt_iterations: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register [P, ...] stacked pairs, the pair axis split over the mesh.

    P must be a multiple of the mesh's pair axis (callers pad, as JAX's
    sharding requires).  ``sample_bits`` [P, ...] holds each pair's bits in
    ``fused_register_step``'s layout for one lane (JAX: one key a pair);
    ``extra_bits`` [P, ...] is required when ``adapt_iterations`` adds
    chunks.  ``src_normals`` may be None (the step does not read it).

    Returns (T [P, 4, 4], ransac_fitness [P], icp_rmse [P]) on the mesh's
    home device.
    """
    line = mesh.line(PAIR_AXIS)
    n_pairs = len(sample_bits)
    if n_pairs % line.n:
        raise ValueError(f"batched_register: {n_pairs} pairs do not split over a pair axis of "
                         f"{line.n}; pad the batch to a multiple")
    batch = min(ransac_iterations, 4096)
    if extra_bits is None and extra_chunk_count(ransac_iterations, adapt_iterations, batch):
        raise ValueError("batched_register: the adaptive budget needs extra_bits, one row a pair")

    def shard(dev, *arrays):
        *clouds, bits, extra = arrays
        return fused_register_step(
            *clouds, bits, extra_bits=extra, device=dev,
            dist_thresh=dist_thresh, icp_thresh=icp_thresh,
            ransac_iterations=ransac_iterations, ransac_batch=batch,
            icp_iterations=icp_iterations, icp_solves_per_nn=icp_solves_per_nn,
            approx_score=approx_score, rescue_restarts=rescue_restarts,
            verify_iters=verify_iters, score_subset=score_subset, rescore_top=rescore_top,
            sample_mode=sample_mode, adapt_iterations=adapt_iterations,
        )

    arrays = [None if a is None else torch.as_tensor(a)
              for a in (src_pts, src_feat, src_mask, src_normals,
                        tgt_pts, tgt_feat, tgt_mask, tgt_normals, sample_bits, extra_bits)]
    return map_shards(line, shard, *arrays, out=3)
