"""End-to-end registration of one pair (port of tpu3dm/registration/pipeline.py).

Load and preprocess two clouds, then single-mode RANSAC on their FPFH
correspondences (coarse; ``restarts`` > 1: the ICP-verified multi-restart
RANSAC of registration/large.py), then ICP on the full-resolution clouds
(fine).  One PipelineConfig threads through every stage.

On CUDA the coarse stage scores its hypotheses on kernel 3's fp32 route at
one lane (csrc/ransac_score.cu) and the full-resolution ICP searches on the
tiled 3-D kernel 4 (csrc/nn_tiled.cu) above 16M entries.

Randomness: ``sample_bits`` are the RANSAC's, [n_chunks_max, K, 2] (or
[restarts, n_chunks_max, K, 2] with ``restarts`` > 1); else ``generator``,
else a generator seeded 0 (JAX's default key is PRNGKey(0)).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud, load_cloud, preprocess_points
from tpu3dm_torch.registration.icp import refine_registration
from tpu3dm_torch.registration.ransac import global_registration
from tpu3dm_torch.registration.result import RegistrationResult
from tpu3dm_torch.utils.logging import setup_logging
from tpu3dm_torch.utils.profiler import fence, profile_block

logger = setup_logging(__name__)


@dataclasses.dataclass
class PairRegistration:
    """The pipeline's output for one cloud pair."""

    ransac: RegistrationResult
    icp: RegistrationResult
    source: ProcessedCloud
    target: ProcessedCloud

    @property
    def transformation(self) -> torch.Tensor:
        return self.icp.transformation


def register_pair(
    src: ProcessedCloud,
    tgt: ProcessedCloud,
    config: PipelineConfig | None = None,
    *,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    restarts: int = 1,
) -> PairRegistration:
    """RANSAC + ICP registration of two preprocessed clouds, on their device.

    ``restarts`` > 1 runs ``large.coarse_pose_with_verification``: near-
    symmetric geometry gives RANSAC aliases whose inlier count ties the true
    pose, and a few verification ICP iterations tell them apart.  The
    default 1 keeps the reference's single RANSAC.
    """
    if config is None:
        config = PipelineConfig.with_voxel_size(src.voxel_size)
    if sample_bits is None and generator is None:
        generator = torch.Generator().manual_seed(0)

    with profile_block("ransac"):
        if restarts > 1:
            from tpu3dm_torch.registration.large import coarse_pose_with_verification

            coarse = coarse_pose_with_verification(
                src.down, tgt.down, config, restarts=restarts, sample_bits=sample_bits,
                generator=generator)
        else:
            coarse = global_registration(src.down, tgt.down, config.ransac, sample_bits,
                                         generator)
        fence(coarse.transformation)
    logger.info("RANSAC: fitness=%.4f rmse=%.4f iters=%d", float(coarse.fitness),
                float(coarse.inlier_rmse), int(coarse.iterations))
    with profile_block("icp"):
        fine = refine_registration(src.full, tgt.full, coarse.transformation, config.icp)
        fence(fine.transformation)
    logger.info("ICP: fitness=%.4f rmse=%.4f iters=%d", float(fine.fitness),
                float(fine.inlier_rmse), int(fine.iterations))
    return PairRegistration(ransac=coarse, icp=fine, source=src, target=tgt)


def register_files(
    src_path: str | Path,
    tgt_path: str | Path,
    config: PipelineConfig | None = None,
    *,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    restarts: int = 1,
    device=None,
) -> PairRegistration:
    """Load, preprocess and register two PLY files (``load_cloud`` raises
    FileNotFoundError or TypeError).  ``device=None`` means CUDA and raises
    without it."""
    if config is None:
        config = PipelineConfig()
    with profile_block("preprocess"):
        src = load_cloud(src_path, config.preprocess, device=device)
        tgt = load_cloud(tgt_path, config.preprocess, device=device)
        fence((src, tgt))
    return register_pair(src, tgt, config, sample_bits=sample_bits, generator=generator,
                         restarts=restarts)


def register_arrays(
    src_points: np.ndarray,
    tgt_points: np.ndarray,
    config: PipelineConfig | None = None,
    *,
    sample_bits: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    restarts: int = 1,
    device=None,
) -> PairRegistration:
    """Preprocess and register two raw host point arrays.  ``device=None``
    means CUDA and raises without it."""
    if config is None:
        config = PipelineConfig()
    with profile_block("preprocess"):
        src = preprocess_points(src_points, config.preprocess, device=device)
        tgt = preprocess_points(tgt_points, config.preprocess, device=device)
        fence((src, tgt))
    return register_pair(src, tgt, config, sample_bits=sample_bits, generator=generator,
                         restarts=restarts)
