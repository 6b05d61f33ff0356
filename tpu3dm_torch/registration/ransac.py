"""RANSAC global registration, single-mode and two-mode (port of
tpu3dm/registration/ransac.py).

Chunks of ``batch_size`` hypotheses: sample distinct triples, fit, checker,
score (the fp32 score goes through ops/ransac_score.score_features at one
lane: csrc/ransac_score.cu on CUDA).  ``ransac_from_correspondences`` keeps
the best hypothesis and re-fits it on its inliers (exact Horn);
``ransac_two_mode`` folds the chunk's best and its best rotation-distinct
hypothesis into two mode slots.  The JAX ``while_loop`` becomes a Python
loop whose confidence stop reads the leader's count on the host once per
chunk.

Randomness: JAX draws each chunk's bits with ``jax.random.bits(k, (K, 2),
uint32)``.  Here the caller passes them (``sample_bits``, int64 holding
uint32 values, [n_chunks_max, K, 2]) or a ``torch.Generator`` draws them,
so tests can hand the port JAX's own bits.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import RansacConfig
from tpu3dm_torch.ops.compact import compaction_permutation
from tpu3dm_torch.parallel.multipair import draw_bits, f32_cos_deg, f32_square
from tpu3dm_torch.registration.hypotheses import (
    prepare_correspondences,
    refit_inliers,
    rot_cos_planar,
    sample_distinct_triples,
    sample_fit_score,
    winner_T,
)
from tpu3dm_torch.registration.result import RegistrationResult

def chunk_count(max_iterations: int, batch_size: int) -> int:
    """Hypothesis chunks of the budget: the first axis of ``sample_bits``."""
    return max(1, -(-max_iterations // batch_size))


def _required_iters(best_count: int, n_valid: int, conf: np.float32, max_iterations: int,
                    min_fit: float = 0.0):
    """Theoretical iterations for confidence, N = log(1-c) / log(1-w^3), in
    fp32 as JAX computes it; the whole budget while w < 0.01 or w is below
    ``min_fit``."""
    w = np.float32(best_count) / np.float32(max(n_valid, 1))
    w3 = np.clip(w * w * w, np.float32(1e-12), np.float32(1.0 - 1e-7))
    req = np.log1p(-conf) / np.log1p(-w3)
    if w < np.float32(0.01) or w < np.float32(min_fit):
        return np.float32(max_iterations)
    return min(req, np.float32(max_iterations))


def _checked_chunk_bits(sample_bits, n_chunks: int, batch_size: int, generator):
    if sample_bits is None:
        sample_bits = draw_bits((n_chunks, batch_size, 2), generator)
    if sample_bits.shape[0] < n_chunks or tuple(sample_bits.shape[1:]) != (batch_size, 2):
        raise ValueError(f"sample_bits must be [{n_chunks}, {batch_size}, 2], "
                         f"got {tuple(sample_bits.shape)}")
    return sample_bits


def _compacted(p_all, q_all, valid):
    """Valid correspondences first (stable), their count, and the score
    operands at one lane: (p, q, valid, n_valid, pq [1, M, 6], F, c, valid1)."""
    order = compaction_permutation(valid)
    p_all, q_all, valid = p_all[order], q_all[order], valid[order]
    pq, F, c = prepare_correspondences(p_all[None], q_all[None])
    return (p_all, q_all, valid, int(torch.sum(valid)), pq, F.contiguous(), c.contiguous(),
            valid[None].contiguous())


def _correspondence_rmse(T, p_all, q_all, valid, thresh_sq: float) -> torch.Tensor:
    """Inlier RMSE of T over the correspondence set."""
    moved = p_all @ T[:3, :3].T + T[:3, 3]
    d2 = torch.sum((moved - q_all) ** 2, dim=1)
    inl = (d2 < thresh_sq) & valid
    return torch.sqrt(torch.sum(torch.where(inl, d2, 0.0)) / torch.clamp_min(torch.sum(inl), 1))


def ransac_from_correspondences(
    p_all: torch.Tensor,
    q_all: torch.Tensor,
    valid: torch.Tensor,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float,
    max_iterations: int = 100_000,
    batch_size: int = 4096,
    confidence: float = 0.999,
    edge_length_ratio: float = 0.9,
    use_checkers: bool = True,
    refit: bool = True,
    early_stop: bool = True,
    early_stop_min_fitness: float = 0.0,
) -> RegistrationResult:
    """Batched RANSAC over a fixed correspondence set (single mode).

    Args:
      p_all, q_all: [M, 3] correspondence points; valid: [M] bool.
      sample_bits: [n_chunks_max, batch_size, 2] int64 of uint32 values,
        chunk i's at [i] (``chunk_count`` gives n_chunks_max; JAX draws
        chunk i's from the i-th ``key, k = split(key)``); drawn from
        ``generator`` when None.
      early_stop: the confidence stop between chunks (the host reads the
        best count once a chunk); False runs the whole budget.
      early_stop_min_fitness: the fitness below which the stop may not
        trigger.

    Returns a RegistrationResult: fitness = inliers / valid correspondences,
    inlier_rmse over the correspondence set, iterations = hypotheses
    evaluated (early stop included).
    """
    thresh_sq = f32_square(dist_thresh)
    conf = np.float32(confidence)
    n_chunks = chunk_count(max_iterations, batch_size)
    sample_bits = _checked_chunk_bits(sample_bits, n_chunks, batch_size, generator)
    p_all, q_all, valid, n_valid, pq, F, c, valid1 = _compacted(p_all, q_all, valid)
    dev = p_all.device

    best_T = torch.eye(4, dtype=torch.float32, device=dev)
    best_count = torch.tensor(-1, dtype=torch.int32, device=dev)
    chunk_i, best_host = 0, -1
    while chunk_i < n_chunks and (not early_stop or chunk_i * batch_size < _required_iters(
            best_host, n_valid, conf, max_iterations, early_stop_min_fitness)):
        bits = sample_bits[chunk_i].to(device=dev, dtype=torch.int64)
        triples = sample_distinct_triples(bits, n_valid)
        R, t, counts = sample_fit_score(
            pq, F, c, valid1, triples[None], thresh_sq,
            edge_length_ratio=edge_length_ratio, use_checkers=use_checkers,
        )
        k = torch.argmax(counts, dim=-1)
        chunk_best = counts[0, k[0]]
        improved = chunk_best > best_count
        best_T = torch.where(improved, winner_T(R, t, k)[0], best_T)
        best_count = torch.where(improved, chunk_best, best_count)
        chunk_i += 1
        if early_stop:
            best_host = int(best_count)

    best_count = torch.clamp_min(best_count, 0)
    if refit:
        best_T, best_count = refit_inliers(best_T, best_count, p_all, q_all, valid, thresh_sq)
    return RegistrationResult(
        transformation=best_T,
        fitness=best_count.to(torch.float32) / float(max(n_valid, 1)),
        inlier_rmse=_correspondence_rmse(best_T, p_all, q_all, valid, thresh_sq),
        iterations=torch.tensor(chunk_i * batch_size, dtype=torch.int32),
    )


def ransac_two_mode(
    p_all: torch.Tensor,
    q_all: torch.Tensor,
    valid: torch.Tensor,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    dist_thresh: float,
    max_iterations: int = 100_000,
    batch_size: int = 4096,
    confidence: float = 0.999,
    edge_length_ratio: float = 0.9,
    use_checkers: bool = True,
    mode_angle_deg: float = 15.0,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Batched RANSAC tracking the best TWO rotationally distinct modes.

    Args:
      p_all, q_all: [M, 3] correspondence points; valid: [M] bool.
      sample_bits: [n_chunks_max, batch_size, 2] int64 of uint32 values, chunk
        i's bits at [i] (``chunk_count`` gives n_chunks_max); drawn from
        ``generator`` when None.

    Returns (primary, secondary) RegistrationResults; ``iterations`` counts
    the hypotheses evaluated, early stop included.
    """
    dev = p_all.device
    thresh_sq = f32_square(dist_thresh)
    conf = np.float32(confidence)
    cos_thr = f32_cos_deg(mode_angle_deg)
    n_chunks = chunk_count(max_iterations, batch_size)
    sample_bits = _checked_chunk_bits(sample_bits, n_chunks, batch_size, generator)
    p_all, q_all, valid, n_valid, pq, F, c, valid1 = _compacted(p_all, q_all, valid)

    def rot_close(Ta, Tb):
        cosang = (torch.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1.0) * 0.5
        return cosang >= cos_thr

    def merge(T1, c1, T2, c2, Tc, cc):
        """Fold candidate (Tc, cc) into the two mode slots: a better candidate
        takes slot 1; near1 only gates slot 2."""
        near1 = rot_close(T1, Tc)
        T1n = torch.where(cc > c1, Tc, T1)
        c1n = torch.maximum(cc, c1)
        far_T2 = torch.where(cc > c1, T1, torch.where(cc > c2, Tc, T2))
        far_c2 = torch.where(cc > c1, c1, torch.maximum(cc, c2))
        return T1n, c1n, torch.where(near1, T2, far_T2), torch.where(near1, c2, far_c2)

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    neg = torch.tensor(-1, dtype=torch.int32, device=dev)
    T1, c1, T2, c2 = eye, neg, eye, neg
    chunk_i = 0
    c1_host = -1
    while chunk_i < n_chunks and chunk_i * batch_size < _required_iters(
        c1_host, n_valid, conf, max_iterations
    ):
        bits = sample_bits[chunk_i].to(device=dev, dtype=torch.int64)
        triples = sample_distinct_triples(bits, n_valid)
        R, t, counts = sample_fit_score(
            pq, F, c, valid1, triples[None], thresh_sq,
            edge_length_ratio=edge_length_ratio, use_checkers=use_checkers,
        )
        ka = torch.argmax(counts, dim=-1)
        Ta, ca = winner_T(R, t, ka)[0], counts[0, ka[0]]
        counts_far = torch.where(rot_cos_planar(Ta[None], R) < cos_thr, counts, -1)
        kb = torch.argmax(counts_far, dim=-1)
        Tb, cb = winner_T(R, t, kb)[0], counts_far[0, kb[0]]
        T1, c1, T2, c2 = merge(T1, c1, T2, c2, Ta, ca)
        T1, c1, T2, c2 = merge(T1, c1, T2, c2, Tb, cb)
        chunk_i += 1
        c1_host = int(c1)

    def result(T, cnt):
        cnt = torch.clamp_min(cnt, 0)
        return RegistrationResult(
            transformation=T,
            fitness=cnt.to(torch.float32) / float(max(n_valid, 1)),
            inlier_rmse=_correspondence_rmse(T, p_all, q_all, valid, thresh_sq),
            iterations=torch.tensor(chunk_i * batch_size, dtype=torch.int32),
        )

    return result(T1, c1), result(T2, c2)


def global_registration(
    src: PointCloud,
    tgt: PointCloud,
    config: RansacConfig,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise_draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    *,
    pairs: torch.Tensor | None = None,
    pairs_valid: torch.Tensor | None = None,
) -> RegistrationResult:
    """FPFH correspondences (mutual per config, corrupted at
    ``config.noise_ratio``), unless ``pairs`` / ``pairs_valid`` are given,
    then ``ransac_from_correspondences`` with the config's budget, checkers
    and early stop.

    JAX splits its key into the correspondences' ``k_corr`` and the RANSAC
    key; here ``noise_draws`` (see ``feature_correspondences``) and
    ``sample_bits`` are passed apart, each drawn from ``generator`` when
    None.  Only 3-point samples are implemented, as in JAX.
    """
    from tpu3dm_torch.registration.correspondence import feature_correspondences, gather_pairs

    if config.sample_size != 3:
        raise NotImplementedError(
            f"sample_size={config.sample_size}: only 3-point minimal samples are supported")
    if pairs is None:
        pairs, pairs_valid = feature_correspondences(
            src, tgt, mutual_filter=config.mutual_filter, noise_ratio=config.noise_ratio,
            noise_draws=noise_draws, generator=generator,
        )
    p_all, q_all = gather_pairs(src, tgt, pairs)
    return ransac_from_correspondences(
        p_all, q_all, pairs_valid, sample_bits, generator,
        dist_thresh=config.dist_thresh,
        max_iterations=config.max_iterations,
        batch_size=config.batch_size,
        confidence=config.confidence,
        edge_length_ratio=config.edge_length_ratio,
        use_checkers=config.use_checkers,
        early_stop=config.early_stop_enabled,
        early_stop_min_fitness=config.early_stop_min_fitness,
    )


def global_registration_two_mode(
    src: PointCloud,
    tgt: PointCloud,
    config: RansacConfig,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise_draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """FPFH correspondences (mutual per config, corrupted at
    ``config.noise_ratio``), then ``ransac_two_mode``.

    JAX splits its key into the correspondences' ``k_corr`` and the RANSAC
    key; here ``noise_draws`` (see ``feature_correspondences``) and
    ``sample_bits`` are passed apart, each drawn from ``generator`` when
    None.
    """
    from tpu3dm_torch.registration.correspondence import feature_correspondences, gather_pairs

    pairs, pairs_valid = feature_correspondences(
        src, tgt, mutual_filter=config.mutual_filter, noise_ratio=config.noise_ratio,
        noise_draws=noise_draws, generator=generator,
    )
    p_all, q_all = gather_pairs(src, tgt, pairs)
    return ransac_two_mode(
        p_all, q_all, pairs_valid, sample_bits, generator,
        dist_thresh=config.dist_thresh,
        max_iterations=config.max_iterations,
        batch_size=config.batch_size,
        confidence=config.confidence,
        edge_length_ratio=config.edge_length_ratio,
        use_checkers=config.use_checkers,
    )
