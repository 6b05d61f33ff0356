"""Weighted rigid fit, batched (port of tpu3dm/registration/kabsch.py: Horn,
and ``fit_rigid_svd``, the reference's Kabsch kept as a parity oracle).

Horn's quaternion method: the optimal rotation is the dominant eigenvector
of a traceless symmetric 4x4 matrix built from the weighted cross
covariance (ops/sym4).  A quaternion never yields a reflection; a
non-finite result falls back to the identity.

The weighted sums over the M rows are elementwise products reduced by
``ops.rowsum.ordered_sum`` (csrc/row_sums.cu on CUDA), whose order depends
on M alone, and the 3x3 products are elementwise sums in a fixed order: a
fit has the same bits alone or among any number of fits.  Neither a batched
matrix product (cuBLAS picks its kernel, and with it the order of a K = M
sum, by the batch count) nor ``torch.sum`` (whose split of a row between
threads follows the number of rows below about a dozen fits) would give
that, and through RANSAC's refit a pair's registration would follow the
number of pairs beside it.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.ops.rowsum import ordered_sum, small_matvec
from tpu3dm_torch.ops.sym4 import dominant_eigvec_sym4


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def fit_rigid_horn(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None
) -> torch.Tensor:
    """Least-squares rigid transform [..., 4, 4] with q ~ R p + t.

    p, q: [..., M, 3]; w: optional [..., M] nonnegative weights.
    """
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    wsum = torch.clamp_min(ordered_sum(w, dim=-1)[..., None], 1e-12)
    wn = w / wsum
    c = ordered_sum(wn[..., None] * torch.cat([p, q], dim=-1), dim=-2)
    cp, cq = c[..., :3], c[..., 3:]
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    S = ordered_sum((wn[..., None] * pc)[..., :, None] * qc[..., None, :], dim=-3)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        -2,
    )
    R = quat_to_rot(dominant_eigvec_sym4(N))
    t = cq - small_matvec(R, cp)
    T = torch.zeros(p.shape[:-2] + (4, 4), dtype=p.dtype, device=p.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    finite = torch.all(torch.isfinite(T).flatten(-2), dim=-1)[..., None, None]
    eye = torch.eye(4, dtype=p.dtype, device=p.device).expand(T.shape)
    return torch.where(finite, T, eye)


def fit_rigid_svd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Kabsch by SVD with the reflection fix (the reference's algorithm, a
    parity oracle for ``fit_rigid_horn``): [..., 4, 4] with q ~ R p + t from
    p, q [..., M, 3]; a non-finite result falls back to the identity."""
    cp = torch.mean(p, dim=-2)
    cq = torch.mean(q, dim=-2)
    H = torch.einsum("...ma,...mb->...ab", p - cp[..., None, :], q - cq[..., None, :])
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    R = torch.einsum("...ba,...cb->...ac", Vt, U)  # V U^T
    flip = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0)
    Vt = Vt.clone()
    Vt[..., 2, :] = Vt[..., 2, :] * flip[..., None]
    R = torch.einsum("...ba,...cb->...ac", Vt, U)
    t = cq - torch.einsum("...ab,...b->...a", R, cp)
    T = torch.zeros(p.shape[:-2] + (4, 4), dtype=p.dtype, device=p.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    finite = torch.all(torch.isfinite(T).flatten(-2), dim=-1)[..., None, None]
    return torch.where(finite, T, torch.eye(4, dtype=p.dtype, device=p.device).expand(T.shape))
