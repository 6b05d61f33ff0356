"""Configuration tree: a copy of tpu3dm/core/config.py.

Every tuning constant of the reference pipeline lives in one frozen dataclass
tree with the reference values as defaults (voxel 0.3, RANSAC threshold
1.5 * voxel, ICP threshold 0.4 * voxel, normal / FPFH radii 2x / 5x voxel).
The fields and defaults are the JAX package's, so one set of values builds
both packages' configs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Ingest + preprocessing."""

    voxel_size: float = 0.3
    normal_radius_mult: float = 2.0  # radius = 2 * voxel
    fpfh_radius_mult: float = 5.0  # radius = 5 * voxel
    # Hybrid-search caps (k nearest within radius); 0 selects the uncapped
    # all-radius-neighbours paths.
    normal_max_nn: int = 30
    fpfh_max_nn: int = 100
    # Full-resolution normals (0 = uncapped).
    full_normal_max_nn: int = 0
    # Gaussian noise on the downsampled cloud; opt-in.
    noise_sigma: float = 0.0
    reference_noise_sigma: float = 0.05

    @property
    def normal_radius(self) -> float:
        return self.voxel_size * self.normal_radius_mult

    @property
    def fpfh_radius(self) -> float:
        return self.voxel_size * self.fpfh_radius_mult


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Global registration."""

    voxel_size: float = 0.3
    dist_thresh_mult: float = 1.5
    max_iterations: int = 100_000
    confidence: float = 0.999
    sample_size: int = 3
    mutual_filter: bool = True
    edge_length_ratio: float = 0.9
    use_checkers: bool = True
    batch_size: int = 4096
    early_stop_enabled: bool = True
    early_stop_min_fitness: float = 0.0
    noise_ratio: float = 0.0
    rescue_restarts: int = 0
    score_subset: int = 0
    rescore_top: int = 128
    sample_rows: int = 0
    adapt_iterations: int = 0

    @property
    def dist_thresh(self) -> float:
        return self.voxel_size * self.dist_thresh_mult


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """ICP refinement."""

    voxel_size: float = 0.3
    dist_thresh_mult: float = 0.4
    max_iterations: int = 30
    relative_fitness: float = 1e-6
    relative_rmse: float = 1e-6
    point_to_plane: bool = True

    @property
    def dist_thresh(self) -> float:
        return self.voxel_size * self.dist_thresh_mult


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full registration pipeline configuration."""

    preprocess: PreprocessConfig = PreprocessConfig()
    ransac: RansacConfig = RansacConfig()
    icp: IcpConfig = IcpConfig()

    @staticmethod
    def with_voxel_size(voxel_size: float, **kw) -> "PipelineConfig":
        """A config with one voxel size threaded through every stage."""
        return PipelineConfig(
            preprocess=PreprocessConfig(voxel_size=voxel_size),
            ransac=RansacConfig(voxel_size=voxel_size, **kw.get("ransac", {})),
            icp=IcpConfig(voxel_size=voxel_size, **kw.get("icp", {})),
        )
