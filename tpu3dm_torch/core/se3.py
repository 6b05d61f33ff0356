"""SE(3) rigid-transform utilities, batched (port of tpu3dm/core/se3.py).

Transforms are ``[..., 4, 4]`` tensors; twists ``xi`` are ``[..., 6]`` in the
JAX package's order ``[rho(3), w(3)]``.  The exp maps keep the reference's
small-angle series branches, as elementwise selects.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` transforms to ``[..., N, 3]`` points: ``p R^T + t``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...nj,...ij->...ni", points, R) + t[..., None, :]


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin x / x, (1 - cos x) / x^2, (1 - A) / x^2) with series
    fallbacks below theta^2 = 1e-8."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS))
    return A, B, C


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: ``[..., 3] -> [..., 3, 3]``."""
    A, B, _ = _coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: ``xi = [rho(3), w(3)] -> [..., 4, 4]``."""
    rho, w = xi[..., :3], xi[..., 3:]
    A, B, C = _coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = torch.einsum("...ij,...j->...i", V, rho)
    out[..., 3, 3] = 1.0
    return out
