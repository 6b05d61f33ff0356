"""Ingest + preprocessing (port of tpu3dm/preprocess/pipeline.py, shared-kNN path).

Host voxel downsample, then ``down_features``: ONE k = fpfh_max_nn top-k
scan feeds both the normals (first normal_max_nn slots, re-masked by the
normal radius) and the 33-D FPFH.  The full-resolution cloud gets its own
normals at the normal radius, as JAX's ``preprocess_points`` gives them:
every neighbour in the radius (``estimate_normals``) when
``full_normal_max_nn`` is 0, else the nearest ``full_normal_max_nn``
(``estimate_normals_capped``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud, from_numpy
from tpu3dm_torch.core.config import PreprocessConfig
from tpu3dm_torch.ops.topk import nn_topk
from tpu3dm_torch.preprocess.fpfh import fpfh_from_knn
from tpu3dm_torch.preprocess.normals import (
    estimate_normals,
    estimate_normals_capped,
    normals_from_knn,
)
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host


@dataclasses.dataclass
class ProcessedCloud:
    """A cloud at two resolutions: ``full`` (with normals) and ``down``
    (downsampled, with normals and FPFH features)."""

    full: PointCloud
    down: PointCloud
    voxel_size: float


def down_features(
    down: PointCloud,
    normal_radius: float,
    fpfh_radius: float,
    *,
    normal_max_nn: int,
    fpfh_max_nn: int,
) -> PointCloud:
    """Normals + FPFH of one downsampled cloud from one shared kNN scan.

    Needs 0 < normal_max_nn <= fpfh_max_nn and normal_radius <= fpfh_radius
    (the reference's 30 <= 100 and 2 * voxel <= 5 * voxel): the slots are
    distance-ascending, so the first normal_max_nn re-masked by the normal
    radius are exactly the normals' hybrid-search set.

    The features are computed on the cloud shifted by its centroid rounded
    to a multiple of 64: |a|^2 + |b|^2 - 2ab loses the neighbour sets to fp32
    cancellation far from the origin, and the rounding makes the shift an
    exact no-op for near-origin clouds.  The returned cloud keeps its
    original points.
    """
    if not (0 < normal_max_nn <= fpfh_max_nn and normal_radius <= fpfh_radius):
        raise NotImplementedError(
            "down_features: only the shared-kNN configuration is ported "
            "(0 < normal_max_nn <= fpfh_max_nn, normal_radius <= fpfh_radius)"
        )
    orig = down
    ctr = torch.round(down.centroid() / 64.0) * 64.0
    down = down.with_(points=down.points - ctr[None, :])
    pts = torch.where(down.mask[:, None], down.points, PAD_SENTINEL)
    n = pts.shape[0]
    k_n = min(normal_max_nn, n)
    d2, idx, valid = nn_topk(
        pts, pts, down.mask, down.mask, k=min(fpfh_max_nn, n), radius=fpfh_radius
    )
    r2_n = float(torch.tensor(normal_radius, dtype=torch.float32) ** 2)
    nvalid = valid[:, :k_n] & (d2[:, :k_n] <= r2_n)
    down = normals_from_knn(down, idx[:, :k_n], nvalid)
    featured = fpfh_from_knn(down, d2, idx, valid)
    return orig.with_(normals=featured.normals, features=featured.features)


def preprocess_points(
    points: np.ndarray,
    config: PreprocessConfig = PreprocessConfig(),
    *,
    device=None,
) -> ProcessedCloud:
    """Voxel downsample on the host, then the downsampled cloud's normals +
    FPFH and the full cloud's normals on ``device``.

    ``device=None`` means CUDA, and raises when CUDA is absent.
    """
    dev = resolve_device(device)
    if config.noise_sigma > 0.0:
        raise NotImplementedError("preprocess_points: noise_sigma > 0 is not ported")
    full = from_numpy(points, device=dev)
    down = voxel_downsample_host(points, config.voxel_size, device=dev)
    down = down_features(
        down,
        config.normal_radius,
        config.fpfh_radius,
        normal_max_nn=config.normal_max_nn,
        fpfh_max_nn=config.fpfh_max_nn,
    )
    if config.full_normal_max_nn > 0:
        full = estimate_normals_capped(full, config.normal_radius,
                                       max_nn=config.full_normal_max_nn)
    else:
        full = estimate_normals(full, config.normal_radius)
    return ProcessedCloud(full=full, down=down, voxel_size=config.voxel_size)
