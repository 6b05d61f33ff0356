"""SE(3) rigid-transform utilities, batched (port of tpu3dm/core/se3.py).

Transforms are ``[..., 4, 4]`` tensors; twists ``xi`` are ``[..., 6]`` in the
JAX package's order ``[rho(3), w(3)]``.  The exp and log maps keep the
reference's small-angle (and, for ``log_so3``, near-pi) branches, as
elementwise selects.

``apply`` and ``exp_se3`` take ``ordered=True`` from the batched steps
(registration/fused.py): their small products become elementwise sums in a
fixed order (``ops.rowsum``) instead of batched GEMMs, whose kernel, and so
whose last bits, follow the number of transforms in the call.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.ops.rowsum import chain_sum, small_matmul, small_matvec

_EPS = 1e-9


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble ``[..., 4, 4]`` transforms from rotations ``[..., 3, 3]`` and
    translations ``[..., 3]``.

    The blocks are concatenated, not written into a zero tensor, so
    ``torch.func.jacfwd`` and ``vmap`` trace through it (and ``inverse`` /
    ``exp_se3``, which assemble with it)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Matrix product A @ B (apply B first, then A)."""
    return A @ B


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def apply(T: torch.Tensor, points: torch.Tensor, *, ordered: bool = False) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` transforms to ``[..., N, 3]`` points: ``p R^T + t``
    (``ordered``: see the module docstring)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if ordered:
        return small_matvec(R[..., None, :, :], points) + t[..., None, :]
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


def exp_se3(xi: torch.Tensor, *, ordered: bool = False) -> torch.Tensor:
    """se(3) exponential: ``xi = [rho(3), w(3)] -> [..., 4, 4]`` (``ordered``:
    see the module docstring)."""
    rho, w = xi[..., :3], xi[..., 3:]
    A, B, C = _coeffs(chain_sum(w * w) if ordered else torch.sum(w * w, dim=-1))
    W = hat(w)
    WW = small_matmul(W, W) if ordered else W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    return make(R, small_matvec(V, rho) if ordered else torch.einsum("...ij,...j->...i", V, rho))


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of ``exp_so3``: ``[..., 3, 3] -> [..., 3]``, with the JAX
    package's branches as elementwise selects: the series 0.5 + theta^2 / 12
    below theta = 1e-4, and within 1e-3 of pi the axis from the largest
    diagonal column of R + I (R + I = 2 n n^T at pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.sin(theta) + _EPS))
    w_generic = scale[..., None] * v
    S = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(S, -1, k[..., None, None].expand(S.shape[:-1] + (1,)))[..., 0]
    n_pi = col / (torch.linalg.vector_norm(col, dim=-1, keepdim=True) + _EPS)
    near_pi = (torch.pi - theta < 1e-3)[..., None]
    return torch.where(near_pi, theta[..., None] * n_pi, w_generic)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of ``exp_se3``: ``[..., 4, 4] -> [rho(3), w(3)]``, with
    V^-1 = I - W / 2 + (1 - A / (2 B)) / theta^2 W^2 (1/12 below theta^2 =
    1e-8)."""
    t = T[..., :3, 3]
    w = log_so3(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _coeffs(theta2)
    small = theta2 < 1e-8
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    coef = torch.where(small, 1.0 / 12.0, (1.0 - A / (2.0 * B + _EPS)) / (theta2 + _EPS))
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, w], dim=-1)


def euler_zyx(angles: torch.Tensor) -> torch.Tensor:
    """R = Rz @ Ry @ Rx from ``[..., 3]`` angles (ax, ay, az): the
    reference visualizer's random-transform convention."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return Rz @ Ry @ Rx


def random_transform(
    generator: torch.Generator | None,
    center: torch.Tensor,
    *,
    max_angle: float = torch.pi / 6,
    max_translation: float = 0.1,
) -> torch.Tensor:
    """Random rigid perturbation about ``center`` ([3]): per-axis uniform
    angles in +-max_angle composed ZYX, a uniform translation in
    +-max_translation, the rotation taken about ``center``.  The angles,
    then the translation, are drawn on the CPU from ``generator`` (JAX
    draws them from ``split(key)``; the two streams differ)."""
    center = torch.as_tensor(center, dtype=torch.float32)
    angles = (torch.rand(3, generator=generator) * 2.0 - 1.0) * max_angle
    trans = (torch.rand(3, generator=generator) * 2.0 - 1.0) * max_translation
    angles, trans = angles.to(center.device), trans.to(center.device)
    R = euler_zyx(angles)
    return make(R, -R @ center + center + trans)


def rotation_geodesic_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between two rotations."""
    M = Ra @ Rb.transpose(-1, -2)
    trace = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    return torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))
