"""Pose arithmetic of the gates, frozen: rotation angle between two poses and
the closed-form alignment RMSE of a cloud under two poses.

The alignment RMSE is the repository's batch gate (``bench.py``): with
A = R_a - R_b and b = t_a - t_b, the mean of |A p + b|^2 over the cloud's
points p is tr(A M2 A^T) + 2 b^T A mu + |b|^2, where mu and M2 are the
cloud's first and second moments, so no [B, N, 3] moved clouds are formed.
"""

from __future__ import annotations

import numpy as np


def moments(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu [..., 3], M2 [..., 3, 3]) of [..., N, 3] points, in float64."""
    p = np.asarray(points, np.float64)
    return p.mean(axis=-2), np.swapaxes(p, -1, -2) @ p / p.shape[-2]


def rotation_deg(T_a: np.ndarray, T_b: np.ndarray) -> np.ndarray:
    """[...] angle in degrees of R_a R_b^T for [..., 4, 4] poses.

    The batch gate takes arccos((tr(R_a R_b^T) - 1) / 2); this is the same
    angle as 2 asin(|R_a - R_b|_F / sqrt(8)), which keeps its digits below
    a micro-degree, where the arccos form reads 0."""
    Ta, Tb = np.asarray(T_a, np.float64), np.asarray(T_b, np.float64)
    f = np.linalg.norm(Ta[..., :3, :3] - Tb[..., :3, :3], axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(f / np.sqrt(8.0), 0.0, 1.0)))


def alignment_rmse(T_a: np.ndarray, T_b: np.ndarray, mu: np.ndarray, M2: np.ndarray) -> np.ndarray:
    """[...] RMS distance between a cloud (moments mu, M2) moved by T_a and by T_b."""
    Ta, Tb = np.asarray(T_a, np.float64), np.asarray(T_b, np.float64)
    A = Ta[..., :3, :3] - Tb[..., :3, :3]
    b = Ta[..., :3, 3] - Tb[..., :3, 3]
    sq = (np.einsum("...ij,...jk,...ik->...", A, M2, A)
          + 2.0 * np.einsum("...i,...ij,...j->...", b, A, mu)
          + np.sum(b * b, axis=-1))
    return np.sqrt(np.maximum(sq, 0.0))


def gate_misses(T: np.ndarray, T_true: np.ndarray, mu: np.ndarray, M2: np.ndarray,
                max_deg: float, max_rmse: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rotation error deg, alignment RMSE, missed) of poses T against T_true;
    a non-finite pose misses."""
    T = np.asarray(T, np.float64)
    finite = np.isfinite(T).all(axis=(-2, -1))
    Tf = np.where(finite[..., None, None], T, np.eye(4))
    rot = np.where(finite, rotation_deg(Tf, T_true), np.inf)
    rmse = np.where(finite, alignment_rmse(Tf, T_true, mu, M2), np.inf)
    return rot, rmse, ~((rot < max_deg) & (rmse < max_rmse))
