"""Synthetic benchmark clouds: a NumPy copy of tpu3dm/io/synthetic.py (arch family).

The same seeds give the same arrays as the JAX package's generators, so both
packages can register the same pairs.
"""

from __future__ import annotations

import numpy as np


def dental_arch_cloud(
    n: int = 20_000,
    *,
    seed: int = 0,
    noise: float = 0.0,
) -> np.ndarray:
    """Dental-arch-like surface: a U-shaped half-tube with cusp bumps, a few
    units across, so voxel_size=0.3 downsamples ~20k points to under a
    thousand."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5 * np.pi, 0.5 * np.pi, size=n)
    v = rng.uniform(0.0, np.pi, size=n)
    arch_r = 5.0
    tube_r = 1.2 + 0.35 * np.sin(6.0 * u) * np.sin(2.0 * v)  # cusps
    cx = arch_r * np.sin(u)
    cy = arch_r * (np.cos(u) - 1.0)
    x = cx + tube_r * np.cos(v) * np.sin(u) * 0.4
    y = cy + tube_r * np.cos(v) * np.cos(u) * 0.4
    z = tube_r * np.sin(v)
    pts = np.stack([x, y, z], axis=1)
    if noise > 0:
        pts += noise * rng.standard_normal(pts.shape)
    return pts


def crop_fraction(points: np.ndarray, fraction: float, axis: int = 0) -> np.ndarray:
    """Keep the lower ``fraction`` of points along ``axis`` (partial overlap)."""
    lo = points[:, axis].min()
    hi = points[:, axis].max()
    keep = points[:, axis] <= lo + fraction * (hi - lo)
    return points[keep]


def make_benchmark_pair(
    n: int = 20_000,
    *,
    seed: int = 0,
    overlap: float = 1.0,
    sigma: float = 0.0,
    family: str = "arch",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source_points, target_points, true_T) benchmark fixture.

    Source = arch cloud; target = the (optionally cropped) copy moved by a
    random rigid T (±30 deg per axis, ±0.5 translation), with optional
    Gaussian sensor noise ``sigma`` on both.  Registration should recover
    ``true_T`` (target <- source).
    """
    if family != "arch":
        raise ValueError(f"unknown benchmark family: {family!r}")
    rng = np.random.default_rng(seed)
    src = dental_arch_cloud(n, seed=seed)
    tgt = src.copy()
    if overlap < 1.0:
        tgt = crop_fraction(tgt, overlap, axis=0)
    angles = rng.uniform(-np.pi / 6, np.pi / 6, size=3)

    def rot(a, b, c):
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        return rz @ ry @ rx

    R = rot(*angles)
    t = rng.uniform(-0.5, 0.5, size=3)
    center = src.mean(axis=0)
    offset = -R @ center + center + t
    tgt = tgt @ R.T + offset
    if sigma > 0:
        tgt = tgt + sigma * rng.standard_normal(tgt.shape)
        src = src + sigma * rng.standard_normal(src.shape)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = offset
    return src, tgt, T
