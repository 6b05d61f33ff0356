"""Step-traced RANSAC (port of tpu3dm/viz/trace.py), the headless
re-expression of the reference's interactive GUI.

The reference's ``VisualizeMatcher`` (src/visualize_matcher/_visualize_matcher
.py:176-616) runs the hand-rolled RANSAC loop in a worker thread, posting the
current/best fitness to the UI every ``update_interval`` iterations and early-
stopping with the confidence formula.  Here the same loop runs as chunks of
``chunk`` hypotheses on the clouds' device, and the host reads each chunk's
result back to append a trace row {iteration, current_fitness, best_fitness,
early_stop, best_T}: everything the GUI displayed (CurFit/BestFit labels,
:489-490), minus the window.  That read per chunk is the point of the
function.  The noise_ratio knob injects bogus correspondences exactly like
the GUI's default settings (noise_ratio=2.0, :161).

Scoring goes through ``ops/ransac_score.score_hypotheses``: dense up to 2^24
hypothesis x correspondence entries (the default chunk of 256 on ~1k rows),
kernel 3's fp32 route on CUDA above.

Randomness: JAX splits ``key`` into the correspondence noise key and one key
a chunk.  Here chunk i samples its triples from ``sample_bits[i]`` ([chunk,
2] uint32 values in int64; JAX: ``bits(k, (chunk, 2))`` after ``key, k =
split(key)``), the noise from ``noise_draws`` (``feature_correspondences``'
layout), or both from ``generator`` (seeded 0 when neither is given).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import RansacConfig
from tpu3dm_torch.ops.compact import compaction_permutation
from tpu3dm_torch.ops.ransac_score import score_hypotheses
from tpu3dm_torch.parallel.multipair import draw_bits, f32_square
from tpu3dm_torch.registration.correspondence import feature_correspondences, gather_pairs
from tpu3dm_torch.registration.hypotheses import sample_distinct_triples
from tpu3dm_torch.registration.kabsch import fit_rigid_horn
from tpu3dm_torch.registration.result import RegistrationResult
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def compute_required_iterations(
    inlier_ratio: float, confidence: float = 0.99, sample_size: int = 3
) -> int:
    """N = log(1-c) / log(1-w^k) (reference: _visualize_matcher.py:356-370)."""
    if inlier_ratio < 0.01:
        return 1 << 30
    w_k = min(inlier_ratio**sample_size, 1 - 1e-12)
    return int(math.log(1 - confidence) / math.log(1 - w_k))


def traced_ransac(
    src: PointCloud,
    tgt: PointCloud,
    config: RansacConfig,
    *,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise_ratio: float = 0.0,
    noise_draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    chunk: int = 256,
    early_stop_threshold: float = 0.5,  # MatcherSettings default (:165)
    early_stop_confidence: float = 0.99,  # MatcherSettings default (:166)
    max_iterations: int | None = None,
) -> tuple[RegistrationResult, list[dict]]:
    """Chunked RANSAC with a host-visible per-chunk trace, on the clouds' device.

    ``sample_bits``: [n_chunks, chunk, 2] with n_chunks = ceil(max_iterations
    / chunk), chunk i's triples at [i]; drawn chunk after chunk from
    ``generator`` when None.  Returns (result, trace rows).  Slower than the
    fused path by design: the host reads back fitness every chunk, like the
    GUI did every update_interval iterations.
    """
    max_iterations = max_iterations or config.max_iterations
    n_chunks = -(-max_iterations // chunk)
    if sample_bits is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    if sample_bits is not None and (sample_bits.shape[0] < n_chunks
                                    or tuple(sample_bits.shape[1:]) != (chunk, 2)):
        raise ValueError(f"sample_bits must be [{n_chunks}, {chunk}, 2], "
                         f"got {tuple(sample_bits.shape)}")
    pairs, valid = feature_correspondences(
        src, tgt, mutual_filter=False, noise_ratio=noise_ratio, noise_draws=noise_draws,
        generator=generator,
    )
    p_all, q_all = gather_pairs(src, tgt, pairs)
    order = compaction_permutation(valid)
    p_all, q_all, valid = p_all[order], q_all[order], valid[order]
    n_valid = int(torch.sum(valid))
    thresh_sq = f32_square(config.dist_thresh)
    dev = p_all.device
    logger.info(
        "Start RANSAC: %d correspondences (noise ratio: %.1f)", n_valid, noise_ratio
    )

    def run_chunk(bits):
        triples = sample_distinct_triples(bits.to(device=dev, dtype=torch.int64), n_valid)
        T = fit_rigid_horn(p_all[triples], q_all[triples])
        counts = score_hypotheses(T[:, :3, :3], T[:, :3, 3], p_all, q_all, valid, thresh_sq)
        best = torch.argmax(counts)
        return T[best], counts[best], counts[-1]

    trace: list[dict] = []
    best_T = torch.eye(4, dtype=torch.float32, device=dev)
    best_count = -1
    it = 0
    early = False
    for i in range(n_chunks):
        bits = sample_bits[i] if sample_bits is not None else draw_bits((chunk, 2), generator)
        T, cnt, last_cnt = run_chunk(bits)
        it += chunk
        cnt = int(cnt)  # the host read of the chunk
        if cnt > best_count:
            best_count = cnt
            best_T = T
        best_fit = best_count / max(n_valid, 1)
        cur_fit = int(last_cnt) / max(n_valid, 1)
        row = {
            "iteration": it,
            "current_fitness": round(cur_fit, 4),
            "best_fitness": round(best_fit, 4),
            "early_stop": False,
            # Per-chunk best pose: lets viz/export.py replay the search the
            # way the reference GUI animated it (_visualize_matcher.py:
            # 452-466 updates the displayed cloud every update_interval).
            "best_T": best_T.cpu().numpy().astype(np.float64).round(6).tolist(),
        }
        if best_fit > early_stop_threshold:
            required = compute_required_iterations(best_fit, early_stop_confidence)
            if it >= required:
                row["early_stop"] = True
                trace.append(row)
                logger.info(
                    "Early stop at iteration %d/%d (fitness: %.4f, required: %d)",
                    it, max_iterations, best_fit, required,
                )
                early = True
                break
        trace.append(row)
    if not early:
        logger.info("RANSAC finished: %d iterations, best fitness %.4f",
                    it, best_count / max(n_valid, 1))

    moved = p_all @ best_T[:3, :3].T + best_T[:3, 3]
    d2 = torch.sum((moved - q_all) ** 2, dim=1)
    inl = (d2 < thresh_sq) & valid
    rmse = float(torch.sqrt(torch.sum(torch.where(inl, d2, 0.0))
                            / torch.clamp_min(torch.sum(inl), 1)))
    result = RegistrationResult(
        transformation=best_T,
        fitness=torch.tensor(best_count / max(n_valid, 1), dtype=torch.float32),
        inlier_rmse=torch.tensor(rmse, dtype=torch.float32),
        iterations=torch.tensor(it, dtype=torch.int32),
    )
    return result, trace
