"""Dominant eigenvector of symmetric traceless 4x4 matrices (port of tpu3dm/ops/sym4.py).

The closed form of the JAX package, kept as it is (``torch.linalg.eigh``
differs in sign and rounding), its 4x4 products and sums elementwise in a
fixed order (``ops.rowsum``), so a matrix's bits do not follow its batch:

  1. lambda_max by 24 Newton steps on the characteristic quartic
     x^4 + p x^2 + q x + r, from the Frobenius upper bound;
  2. the eigenvector as the adjugate column of N - lambda I with the largest
     diagonal cofactor.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.ops.rowsum import chain_sum, small_matmul

_NEWTON_ITERS = 24
_MINOR_IDX = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]


def _trace(M: torch.Tensor) -> torch.Tensor:
    return chain_sum(torch.diagonal(M, dim1=-2, dim2=-1))


def _minor(A: torch.Tensor, rows, cols) -> torch.Tensor:
    """Determinant of A's 3x3 submatrix at ``rows`` x ``cols``, read through
    views of A's entries: no index tensor is made on the host, so a CUDA
    graph can capture it."""

    def M(i, j):
        return A[..., rows[i], cols[j]]

    return (
        M(0, 0) * (M(1, 1) * M(2, 2) - M(1, 2) * M(2, 1))
        - M(0, 1) * (M(1, 0) * M(2, 2) - M(1, 2) * M(2, 0))
        + M(0, 2) * (M(1, 0) * M(2, 1) - M(1, 1) * M(2, 0))
    )


def _det4(A: torch.Tensor) -> torch.Tensor:
    total = None
    for j in range(4):
        term = ((-1.0) ** j) * A[..., 0, j] * _minor(A, (1, 2, 3), _MINOR_IDX[j])
        total = term if total is None else total + term
    return total


def dominant_eigvec_sym4(N: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector ``[..., 4]`` for the largest eigenvalue of
    ``[..., 4, 4]`` symmetric traceless matrices."""
    N2 = small_matmul(N, N)
    p = -0.5 * _trace(N2)
    q = -_trace(small_matmul(N2, N)) / 3.0
    r = _det4(N)
    lam = torch.sqrt(torch.clamp_min(-2.0 * p, 0.0)) + 1e-6
    for _ in range(_NEWTON_ITERS):
        lam2 = lam * lam
        f = ((lam2 + p) * lam + q) * lam + r
        fp = (4.0 * lam2 + 2.0 * p) * lam + q
        lam = lam - f / torch.where(torch.abs(fp) > 1e-20, fp, 1e-20)

    A = N - lam[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)
    # adj(A)[i, j] = (-1)^(i+j) minor(A, j, i); column j stacked over i.
    adj_cols = torch.stack(
        [
            torch.stack(
                [((-1.0) ** (i + j)) * _minor(A, _MINOR_IDX[j], _MINOR_IDX[i]) for i in range(4)],
                dim=-1,
            )
            for j in range(4)
        ],
        dim=-1,
    )
    diag = torch.stack([adj_cols[..., k, k] for k in range(4)], dim=-1)
    best = torch.argmax(torch.abs(diag), dim=-1)
    v = torch.gather(adj_cols, -1, best[..., None, None].expand(best.shape + (4, 1)))[..., 0]
    norm = torch.sqrt(chain_sum(v * v))[..., None]
    ok = norm > 1e-20
    fallback = torch.eye(4, dtype=N.dtype, device=N.device)[0]  # (1, 0, 0, 0), made on the device
    return torch.where(ok, v / torch.where(ok, norm, 1.0), fallback)
