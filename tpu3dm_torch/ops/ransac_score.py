"""Batched RANSAC hypothesis scoring (port of tpu3dm/ops/ransac_score.py).

For hypothesis k (R_k, t_k) and correspondence n (p_n, q_n),

    |R_k p_n + t_k - q_n|^2 = (|p_n|^2 + |q_n|^2) + |t_k|^2
        + [p_n, vec(q_n p_n^T), q_n, 0] . [2 R_k^T t_k, -2 vec(R_k), -2 t_k, 0]

a rank-15 bilinear form: F [N, 16] per correspondence, H [K, 16] per
hypothesis.  ``score_features`` counts inliers from those features; on CUDA
it launches csrc/ransac_score.cu (replacing the TPU's ``_score_kernel``),
which never builds the [B, K, N] distance tensor (34 GB in fp32 at B=2048,
K=4096, N=1024).  Each feature dtype has its own kernel: bf16 H and F (the
``approx_score`` route) a tensor-core product, fp32 H and F the scalar
fp32 kernel.  ``score_hypotheses`` is JAX's size-adaptive scorer over
unbatched R, t, p, q: the dense [K, N] matrix up to DENSE_MAX_ENTRIES
entries, one lane of ``score_features`` (fp32) above.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.csrc import (
    FLOAT,
    INT,
    PTR,
    Kernel,
    check_cuda_tensors,
    check_dtype,
    dispatch,
)
from tpu3dm_torch.ops.nn import lane_slices
from tpu3dm_torch.ops.rowsum import chain_sum

FEAT_DIM = 16  # 15 used + 1 zero pad
# Up to this many hypothesis x correspondence entries ``score_hypotheses``
# materializes the [K, N] matrix (16M entries = 64 MB fp32), as JAX does.
DENSE_MAX_ENTRIES = 1 << 24
SCORE_ARGS = [PTR, PTR, PTR, PTR, PTR, FLOAT, PTR, INT, INT, INT]
RANSAC_SCORE = Kernel("ransac_score", "ransac_score.cu", "t3t_ransac_score", SCORE_ARGS)
RANSAC_SCORE_BF16 = Kernel(
    "ransac_score_bf16", "ransac_score.cu", "t3t_ransac_score_bf16", SCORE_ARGS,
)


def corres_features(p: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(F [..., N, 16], c [..., N]): F = [p, vec(q p^T), q, 0], c = |p|^2 + |q|^2."""
    outer = (q[..., :, None] * p[..., None, :]).reshape(p.shape[:-1] + (9,))
    pad = torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    F = torch.cat([p, outer, q, pad], dim=-1)
    c = chain_sum(p * p) + chain_sum(q * q)
    return F, c


def hypothesis_features(R: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(H [..., K, 16], e [..., K]) from R [..., K, 3, 3], t [..., K, 3]:
    H = [2 R^T t, -2 vec(R), -2 t, 0], e = |t|^2."""
    Rt_t = torch.einsum("...ij,...i->...j", R, t)
    H = torch.cat(
        [2.0 * Rt_t, -2.0 * R.reshape(R.shape[:-2] + (9,)), -2.0 * t, torch.zeros_like(t[..., :1])],
        dim=-1,
    )
    e = torch.sum(t * t, dim=-1)
    return H, e


def score_features_plain(H, e, F, c, mask, thresh_sq: float) -> torch.Tensor:
    """Plain PyTorch version of ``score_features`` (any device), chunked over
    pair lanes so the dense [b, K, N] block stays small.  bf16 features are
    upcast to fp32, which holds every bf16 value exactly."""
    H, F = H.float(), F.float()
    b, k, n = H.shape[0], H.shape[1], F.shape[1]
    out = []
    for s in lane_slices(b, k * n):
        d2 = H[s] @ F[s].transpose(-1, -2) + c[s][:, None, :] + e[s][:, :, None]
        hits = (d2 < thresh_sq) & mask[s][:, None, :]
        out.append(torch.sum(hits, dim=-1, dtype=torch.int32))
    return torch.cat(out)


# Error of an entry's d2 in each kernel, relative to the sum of its terms'
# magnitudes (sum_i |H_i F_i| + |c| + |e|): the fp32 kernel's 16 fmaf steps
# and 2 adds each round to nearest (2^-24 relative), with 1% slack; the bf16
# kernel's tensor core may truncate at each of its 16 product additions (an
# ulp, 2^-23 relative, each), then 2 adds round, with slack.  The plain
# version's sums fit either bound.
FP32_CHAIN_REL = 18 * 2.0**-24 * 1.01
BF16_MMA_REL = 20 * 2.0**-23


def score_count_bracket(H, e, F, c, mask, thresh_sq: float, rel: float):
    """Float64 bracket of ``score_features``'s counts (any device).

    With d2 computed in float64 from the inputs' values and an allowed
    error delta = rel * (|H_k|.|F_n| + |c_n| + |e_k|) an entry, returns
    (sure, near) [B, K] int64: the valid entries with d2 < thresh_sq - delta,
    and those with |d2 - thresh_sq| <= delta.  A count whose every entry errs
    by at most delta lies in [sure, sure + near]; a NaN entry is in neither.
    """
    b, k, n = H.shape[0], H.shape[1], F.shape[1]
    sure, near = [], []
    for s in lane_slices(b, k * n):
        H64, F64 = H[s].double(), F[s].double()
        c64, e64 = c[s].double()[:, None, :], e[s].double()[:, :, None]
        d2 = (H64 @ F64.transpose(-1, -2)).add_(c64).add_(e64)
        tol = (H64.abs() @ F64.abs().transpose(-1, -2)).add_(c64.abs()).add_(e64.abs()).mul_(rel)
        m = mask[s][:, None, :]
        sure.append(((d2 < thresh_sq - tol) & m).sum(-1))
        near.append((((d2 - thresh_sq).abs() <= tol) & m).sum(-1))
        del d2, tol
    return torch.cat(sure), torch.cat(near)


def score_features(
    H: torch.Tensor,
    e: torch.Tensor,
    F: torch.Tensor,
    c: torch.Tensor,
    mask: torch.Tensor,
    thresh_sq: float,
) -> torch.Tensor:
    """Inlier counts [B, K] int32: #{n : (H_k . F_n + c_n) + e_k < thresh_sq, mask_n}.

    Args:
      H: [B, K, 16] and F: [B, N, 16], both float32 or both bfloat16 (on
        CUDA bf16 runs the tensor-core kernel, fp32 the fp32 one).
      e: [B, K], c: [B, N] float32.
      mask: [B, N] bool.
      thresh_sq: squared inlier threshold (an fp32 value).
    """
    where = "score_features"
    if H.dtype != F.dtype or H.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{where}: H and F must both be float32 or both bfloat16, got "
                        f"{H.dtype} and {F.dtype}")
    if H.ndim != 3 or F.ndim != 3 or H.shape[-1] != FEAT_DIM or F.shape[-1] != FEAT_DIM:
        raise ValueError(f"{where}: expected H [B, K, 16] and F [B, N, 16], got "
                         f"{tuple(H.shape)} and {tuple(F.shape)}")
    b, k, n = H.shape[0], H.shape[1], F.shape[1]
    if F.shape[0] != b or e.shape != (b, k) or c.shape != (b, n) or mask.shape != (b, n):
        raise ValueError(f"{where}: e {tuple(e.shape)}, c {tuple(c.shape)} or "
                         f"mask {tuple(mask.shape)} do not match H and F")
    if dispatch(where, H, e, F, c, mask) == "cpu":
        return score_features_plain(H, e, F, c, mask, thresh_sq)
    check_dtype(where, torch.float32, e=e, c=c)
    check_dtype(where, torch.bool, mask=mask)
    counts = torch.empty((b, k), dtype=torch.int32, device=H.device)
    dev = check_cuda_tensors(where, b, H=H, e=e, F=F, c=c, mask=mask, counts=counts)
    kernel = RANSAC_SCORE_BF16 if H.dtype == torch.bfloat16 else RANSAC_SCORE
    kernel.launch(
        dev, H.data_ptr(), e.data_ptr(), F.data_ptr(), c.data_ptr(), mask.data_ptr(),
        float(thresh_sq), counts.data_ptr(), b, k, n,
    )
    return counts


def score_hypotheses_dense(R, t, p, q, mask, dist_thresh_sq: float) -> torch.Tensor:
    """Inlier counts [..., K] int32 with the [..., K, N] distance matrix
    materialized (the JAX ``score_hypotheses_dense``)."""
    F, c = corres_features(p, q)
    H, e = hypothesis_features(R, t)
    d2 = H @ F.transpose(-1, -2) + c[..., None, :] + e[..., :, None]
    hits = (d2 < dist_thresh_sq) & mask[..., None, :]
    return torch.sum(hits, dim=-1, dtype=torch.int32)


def score_hypotheses(R, t, p, q, mask, dist_thresh_sq: float) -> torch.Tensor:
    """Size-adaptive inlier counts [K] int32 of K hypotheses (R [K, 3, 3], t
    [K, 3]) over one correspondence set (p, q [N, 3], mask [N]), JAX's
    ``score_hypotheses``: dense up to DENSE_MAX_ENTRIES entries, above it one
    lane of ``score_features`` on fp32 features (kernel 3's fp32 route on
    CUDA, its plain version on the CPU)."""
    if R.shape[0] * p.shape[0] <= DENSE_MAX_ENTRIES:
        return score_hypotheses_dense(R, t, p, q, mask, dist_thresh_sq)
    F, c = corres_features(p, q)
    H, e = hypothesis_features(R, t)
    return score_features(H[None].contiguous(), e[None].contiguous(), F[None].contiguous(),
                          c[None].contiguous(), mask[None].contiguous(), dist_thresh_sq)[0]
