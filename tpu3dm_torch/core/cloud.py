"""Point-cloud container: padded, masked tensors (port of tpu3dm/core/cloud.py).

Every cloud is padded to a capacity and carries a validity mask, so one
batch holds clouds of different sizes.  ``points`` is ``[..., N, 3]`` with
padding rows zeroed; normals and features share the padding layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu3dm_torch import resolve_device

# Coordinate for padding rows that must never win a nearest-neighbour race.
PAD_SENTINEL = 1.0e9


def round_up(n: int, multiple: int) -> int:
    """Round ``n`` up to the next multiple of ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple


def bucket_size(n: int, multiple: int = 256) -> int:
    """Padded size for ``n`` points: the JAX package's bucketing, so both
    packages give a cloud the same capacity."""
    if n <= multiple:
        return multiple
    p = 1 << (int(n - 1).bit_length())
    for frac in (p // 2 + p // 4, p // 2 + p // 2):
        cand = round_up(frac, multiple)
        if cand >= n:
            return cand
    return round_up(p, multiple)


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point cloud of tensors.

    Attributes:
      points:   ``[..., N, 3] float32``; padding rows are zero.
      mask:     ``[..., N] bool``, True for real points.
      normals:  ``[..., N, 3] float32`` unit normals, or zeros if absent.
      features: ``[..., N, F] float32`` (FPFH: F=33), or width 0 if absent.
    """

    points: torch.Tensor
    mask: torch.Tensor
    normals: torch.Tensor
    features: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def with_(self, **kw) -> PointCloud:
        return dataclasses.replace(self, **kw)

    def centroid(self) -> torch.Tensor:
        """Mask-aware centroid ``[..., 3]``."""
        m = self.mask.to(self.points.dtype)[..., None]
        denom = torch.clamp_min(m.sum(-2), 1.0)
        return (self.points * m).sum(-2) / denom


def from_numpy(
    points: np.ndarray,
    *,
    normals: np.ndarray | None = None,
    features: np.ndarray | None = None,
    capacity: int | None = None,
    pad_multiple: int = 256,
    device=None,
) -> PointCloud:
    """Build a padded PointCloud from host arrays of the valid rows."""
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [N,3], got {points.shape}")
    n = points.shape[0]
    if n == 0:
        raise ValueError("Point cloud is empty")
    cap = capacity if capacity is not None else bucket_size(n, pad_multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")

    def pad(a: np.ndarray | None, width: int) -> np.ndarray:
        out = np.zeros((cap, width if a is None else a.shape[1]), np.float32)
        if a is not None:
            out[:n] = a
        return out

    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    dev = resolve_device(device)
    return PointCloud(
        points=torch.from_numpy(pad(points, 3)).to(dev),
        mask=torch.from_numpy(mask).to(dev),
        normals=torch.from_numpy(pad(normals, 3)).to(dev),
        features=torch.from_numpy(pad(features, 0)).to(dev),
    )


def from_reference_arrays(d: dict[str, np.ndarray], *, device=None) -> PointCloud:
    """The port's PointCloud from the padded arrays of a JAX ``PointCloud``.

    ``d`` holds ``points``, ``normals``, ``features`` and ``mask`` exactly as
    the JAX cloud stores them (capacity padding included), e.g.
    ``{f: np.asarray(getattr(pc, f)) for f in ("points", ...)}``.  This is
    how preprocessed state crosses from the reference to the port.
    """
    points = np.asarray(d["points"], np.float32)
    mask = np.asarray(d["mask"], bool)
    if points.shape[:-1] != mask.shape or points.shape[-1] != 3:
        raise ValueError(f"points {points.shape} and mask {mask.shape} disagree")
    normals = np.asarray(d.get("normals", np.zeros_like(points)), np.float32)
    features = np.asarray(
        d.get("features", np.zeros(mask.shape + (0,), np.float32)), np.float32
    )
    dev = resolve_device(device)
    return PointCloud(
        points=torch.from_numpy(points.copy()).to(dev),
        mask=torch.from_numpy(mask.copy()).to(dev),
        normals=torch.from_numpy(normals.copy()).to(dev),
        features=torch.from_numpy(features.copy()).to(dev),
    )


def to_numpy(pc: PointCloud) -> dict[str, np.ndarray]:
    """Strip the padding and return host arrays: points, and the normals
    (when any is non-zero) and features (when the cloud has any) of the
    valid rows."""
    mask = pc.mask.cpu().numpy()
    out = {"points": pc.points.cpu().numpy()[mask]}
    normals = pc.normals.cpu().numpy()
    if normals.shape[-1] == 3 and np.any(normals):
        out["normals"] = normals[mask]
    if pc.features.shape[-1] > 0:
        out["features"] = pc.features.cpu().numpy()[mask]
    return out
