"""Hypothesis-parallel RANSAC over the block axis (port of tpu3dm/parallel/sharded_ransac.py).

Every block position sees the whole (replicated) correspondence set, fits,
checks and scores its own ``iterations // nb`` hypotheses with the kernels
of the single-pair path (the fp32 score, csrc/ransac_score.cu, on CUDA),
and the global champion is elected by an all-gather of the positions'
champions and a first argmax.

Randomness: JAX draws position b's triples from ``fold_in(key, b)``; here
position b takes ``sample_bits[b]`` ([nb, k_local, 2] uint32 values in
int64, the layout ``hypotheses.sample_distinct_triples`` takes), drawn from
``generator`` when None.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.ops.compact import compaction_permutation
from tpu3dm_torch.parallel.mesh import BLOCK_AXIS, Mesh
from tpu3dm_torch.parallel.multipair import checked_bits, f32_square
from tpu3dm_torch.registration.hypotheses import (
    prepare_correspondences,
    sample_distinct_triples,
    sample_fit_score,
    winner_T,
)
from tpu3dm_torch.registration.result import RegistrationResult


def sharded_ransac(
    mesh: Mesh,
    p_all: torch.Tensor,
    q_all: torch.Tensor,
    valid: torch.Tensor,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float,
    iterations: int = 16384,
    edge_length_ratio: float = 0.9,
    use_checkers: bool = True,
) -> RegistrationResult:
    """Fixed-budget RANSAC with the hypotheses sharded over the block axis.

    ``iterations`` hypotheses in all, ``k_local = max(1, iterations // nb)``
    a position.  p_all, q_all [M, 3]; valid [M] bool.  Returns the elected
    transform with JAX's fitness (champion count / valid rows), inlier RMSE
    and ``iterations = k_local * nb``, on the mesh's home device.
    """
    line = mesh.line(BLOCK_AXIS)
    nb = line.n
    k_local = max(1, iterations // nb)
    thresh_sq = f32_square(dist_thresh)
    home = mesh.home
    bits = checked_bits("sample_bits", sample_bits, (nb, k_local, 2), generator, home)

    # Valid rows first (stable), for uniform index sampling.
    order = compaction_permutation(valid).to(torch.int64)
    p_all, q_all, valid = p_all[order].to(home), q_all[order].to(home), valid[order].to(home)
    n_valid = torch.sum(valid.to(torch.int32))

    counts, Ts = [None] * nb, [None] * nb
    for i in line.local():
        dev = line.devices[i]
        p, q, v = p_all.to(dev), q_all.to(dev), valid.to(dev)
        triples = sample_distinct_triples(bits[i].to(dev), n_valid.to(dev))
        pq, F, c = prepare_correspondences(p[None], q[None])
        R, t, cnt = sample_fit_score(pq, F, c, v[None], triples[None], thresh_sq,
                                     edge_length_ratio=edge_length_ratio,
                                     use_checkers=use_checkers)
        best = torch.argmax(cnt, dim=-1)
        counts[i] = cnt[0, best[0]]
        Ts[i] = winner_T(R, t, best)[0]

    # Election: every position's champion, the first largest count.
    all_counts, all_T = line.all_gather(counts), line.all_gather(Ts)
    win = torch.argmax(all_counts)
    best_T, best_count = all_T[win], torch.clamp_min(all_counts[win], 0)
    fitness = best_count.to(torch.float32) / torch.clamp_min(n_valid, 1)
    moved = p_all @ best_T[:3, :3].T + best_T[:3, 3]
    d2 = torch.sum((moved - q_all) ** 2, dim=1)
    inl = (d2 < thresh_sq) & valid
    rmse = torch.sqrt(torch.sum(torch.where(inl, d2, 0.0)) / torch.clamp_min(torch.sum(inl), 1))
    return RegistrationResult(
        transformation=best_T, fitness=fitness, inlier_rmse=rmse,
        iterations=torch.tensor(k_local * nb, dtype=torch.int32),
    )
