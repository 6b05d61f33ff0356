"""Host voxel-grid downsampling (port of tpu3dm/preprocess/voxel.py, NumPy branch).

Every point maps to the voxel containing it, relative to the cloud's min
bound, and each output point is the mean of its voxel's members, in
lexicographic voxel order.  Ingest is a host stage, as in the reference.
"""

from __future__ import annotations

import numpy as np

from tpu3dm_torch.core.cloud import PointCloud, from_numpy


def voxel_means(points, voxel_size: float) -> np.ndarray:
    """[V, 3] float32 voxel means in lexicographic voxel order."""
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    ijk = np.floor((pts - lo[None, :]) / float(voxel_size)).astype(np.int64)
    # unique(axis=0) sorts lexicographically.
    _, inverse, counts = np.unique(ijk, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inverse.reshape(-1), pts)
    return (sums / counts[:, None]).astype(np.float32)


def voxel_downsample_host(
    points, voxel_size: float, pad_multiple: int = 256, *, device=None
) -> PointCloud:
    """Downsample on the host and pad to the bucketed capacity on ``device``."""
    return from_numpy(
        voxel_means(points, voxel_size), pad_multiple=pad_multiple, device=device
    )
