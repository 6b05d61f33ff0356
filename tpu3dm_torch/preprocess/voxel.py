"""Host voxel-grid downsampling (port of tpu3dm/preprocess/voxel.py, native branch).

Every point maps to the voxel containing it, relative to the cloud's min
bound, and each output point is the mean of its voxel's members, in
lexicographic voxel order.  Ingest is a host stage, as in the reference:
``t3n_voxel_downsample`` of csrc/host.cpp, the JAX package's native voxel
grid, which its ``voxel_downsample_host`` calls whenever that tier is built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu3dm_torch.core.cloud import PointCloud, from_numpy
from tpu3dm_torch.csrc import host_library


def voxel_means(points, voxel_size: float) -> np.ndarray:
    """[V, 3] float32 voxel means in lexicographic voxel order."""
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    out = np.empty((n, 3), dtype=np.float64)
    f64 = ctypes.POINTER(ctypes.c_double)
    m = host_library().t3n_voxel_downsample(
        pts.ctypes.data_as(f64), n, float(voxel_size), out.ctypes.data_as(f64), n
    )
    if m < 0:  # cannot happen: there are at most as many voxels as points
        raise RuntimeError("t3n_voxel_downsample: output capacity exceeded")
    return out[:m].astype(np.float32)


def voxel_downsample_host(
    points, voxel_size: float, pad_multiple: int = 256, *, device=None
) -> PointCloud:
    """Downsample on the host and pad to the bucketed capacity on ``device``."""
    return from_numpy(
        voxel_means(points, voxel_size), pad_multiple=pad_multiple, device=device
    )
