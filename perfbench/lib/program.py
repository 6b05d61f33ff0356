"""What the harness takes from the program under test, ``tpu3dm_torch``: its
configuration tree, built from a configuration file's settings.  The
runners import the program's entry points themselves, inside their
set-up, so that importing the harness loads no program code."""

from __future__ import annotations


def pipeline_config(cfg: dict):
    """The program's ``PipelineConfig`` for a configuration file's settings."""
    from tpu3dm_torch.core.config import IcpConfig, PipelineConfig, PreprocessConfig, RansacConfig

    v = cfg["voxel_size"]
    return PipelineConfig(
        preprocess=PreprocessConfig(
            voxel_size=v, normal_radius_mult=cfg["normal_radius_mult"],
            fpfh_radius_mult=cfg["fpfh_radius_mult"], normal_max_nn=cfg["normal_max_nn"],
            fpfh_max_nn=cfg["fpfh_max_nn"]),
        ransac=RansacConfig(voxel_size=v, dist_thresh_mult=cfg["ransac_dist_mult"],
                            rescue_restarts=cfg.get("rescue_restarts", 0)),
        icp=IcpConfig(voxel_size=v, dist_thresh_mult=cfg["icp_dist_mult"]),
    )


def icp_thresh(cfg: dict) -> float:
    return cfg["voxel_size"] * cfg["icp_dist_mult"]


def normal_radius(cfg: dict) -> float:
    return cfg["voxel_size"] * cfg["normal_radius_mult"]
