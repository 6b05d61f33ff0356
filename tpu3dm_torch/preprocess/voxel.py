"""Voxel-grid downsampling (port of tpu3dm/preprocess/voxel.py).

Every point maps to the voxel containing it, relative to the cloud's min
bound, and each output point is the mean of its voxel's members, in
lexicographic voxel order.  Two routes:

  - ``voxel_downsample_host``: the ingest route, as in the reference:
    ``t3n_voxel_downsample`` of csrc/host.cpp, the JAX package's native
    voxel grid, which its ``voxel_downsample_host`` calls whenever that
    tier is built;
  - ``voxel_downsample`` / ``compact``: the same grid on the cloud's device
    (a stable sort on the voxel coordinates and segment sums), for clouds
    that are already there.

The device grid computes what the host grid computes, in float64: voxel
coordinates floor((p - lo) * (1 / voxel)) and per-voxel sums divided by the
count, rounded to float32 once.  So its means equal the host grid's, where
JAX's device version divides in float32 and can put a point within an ulp
of a voxel face into the neighbouring voxel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu3dm_torch.core.cloud import PointCloud, bucket_size, from_numpy
from tpu3dm_torch.csrc import host_library

_INT_BIG = 2**30  # voxel coordinate of padding rows: they sort last


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


def voxel_downsample(pc: PointCloud, voxel_size: float) -> PointCloud:
    """One mean point per occupied voxel of a [N, 3] cloud, on its device.

    Returns a cloud of the same capacity: the valid rows (lexicographic
    voxel order) carry the voxel means, the rest are zero, masked padding.
    """
    pts, mask = pc.points, pc.mask
    n = pts.shape[0]
    p64 = pts.to(torch.float64)
    lo = torch.amin(torch.where(mask[:, None], p64, torch.inf), dim=0)
    ijk = torch.floor((p64 - lo) * (1.0 / float(voxel_size))).to(torch.int64)
    ijk = torch.where(mask[:, None], ijk, _INT_BIG)
    # Lexicographic (i, j, k) order: stable sorts on k, then j, then i.
    order = torch.argsort(ijk[:, 2], stable=True)
    for axis in (1, 0):
        order = order[torch.argsort(ijk[order, axis], stable=True)]
    s_ijk = ijk[order]
    is_new = torch.ones((n,), dtype=torch.bool, device=pts.device)
    is_new[1:] = torch.any(s_ijk[1:] != s_ijk[:-1], dim=1)
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    w = mask[order].to(torch.float64)
    sums = torch.zeros((n, 3), dtype=torch.float64, device=pts.device)
    sums.index_add_(0, seg, p64[order] * w[:, None])
    cnts = torch.zeros((n,), dtype=torch.float64, device=pts.device)
    cnts.index_add_(0, seg, w)
    out_mask = cnts > 0.0
    means = torch.where(out_mask[:, None], sums / torch.clamp_min(cnts, 1.0)[:, None], 0.0)
    means = means.to(torch.float32)
    return PointCloud(
        points=means,
        mask=out_mask,
        normals=torch.zeros_like(means),
        features=torch.zeros((n, 0), dtype=torch.float32, device=pts.device),
    )


def compact(pc: PointCloud, pad_multiple: int = 256) -> PointCloud:
    """Strip the padding of a [N, 3] cloud and re-bucket its valid points to
    a tight capacity (``bucket_size``), on its device; normals and features
    are dropped, as JAX's ``compact`` drops them.  One host sync (the count).

    Use after ``voxel_downsample`` so the O(N^2) stages that follow run at the
    downsampled size, not the raw capacity.
    """
    valid = pc.points[pc.mask]
    n = valid.shape[0]
    if n == 0:
        raise ValueError("Point cloud is empty")
    cap = bucket_size(n, pad_multiple)
    points = torch.zeros((cap, 3), dtype=torch.float32, device=valid.device)
    points[:n] = valid
    mask = torch.zeros((cap,), dtype=torch.bool, device=valid.device)
    mask[:n] = True
    return PointCloud(
        points=points,
        mask=mask,
        normals=torch.zeros_like(points),
        features=torch.zeros((cap, 0), dtype=torch.float32, device=valid.device),
    )
