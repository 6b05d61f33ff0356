"""Closed-form symmetric 3x3 eigen-solver, batched (port of tpu3dm/ops/eigh3.py).

The trigonometric solution (Smith 1961) for the spectrum, and the smallest
eigenvector as the largest cross product of rows of ``A - lambda_min I``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``[..., 3, 3]`` matrices, ascending ``[..., 3]``."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, _EPS))
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    # Diagonal matrices (p1 ~ 0): the eigenvalues are the sorted diagonal.
    diag_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values
    analytic = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    return torch.where((p1 <= _EPS)[..., None], diag_sorted, analytic)


def smallest_eigvec_sym3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpair: (eigenvalue ``[...]``, unit eigenvector ``[..., 3]``),
    with a fixed fallback axis for isotropic inputs."""
    lam = eigvals_sym3(A)[..., 0]
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack(
        [torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2), torch.linalg.cross(r1, r2)],
        dim=-2,
    )
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    vnorm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device).expand(v.shape)
    ok = vnorm > 1e-10
    v = torch.where(ok, v / torch.where(ok, vnorm, 1.0), fallback)
    return lam, v
