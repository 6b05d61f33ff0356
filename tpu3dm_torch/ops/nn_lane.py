"""Per-pair-lane NN searches on hand-written CUDA kernels (port of tpu3dm/ops/nn_lane.py).

Two wrappers with the JAX contracts, batched over a leading pair dimension:

  - ``nn_search_lane``: top-1 nearest neighbour, on two kernels of
    csrc/lane_nn.cu: ``t3t_lane_nn_smalld`` for d = 3 (replacing
    ``_lane_nn_smalld_kernel``) — the ICP and rescue-verification searches —
    and ``t3t_lane_nn_wide`` for 8 <= d <= 64 (replacing
    ``_lane_nn_mxu_kernel``) — the non-mutual FPFH correspondences, at
    d = 33 on the route of kernel 5 (csrc/fpfh_search.cuh);
  - ``nn_mutual_mask_lane``: forward 33-D NN plus the mutuality test against
    GLOBAL column minima (kernel csrc/lane_mutual.cu, one block a lane on the
    FPFH lane tile, replacing ``_lane_mutual_kernel``) — the FPFH
    correspondence stage of ``nn_impl="lane"``;
  - ``nn_mutual_mask_batched``: the same search with the JAX ``nn_mutual_mask``
    options of the other routes: a bf16 feature cross (``approx``) and a
    cross stored as bf16 (``cross_bf16``, ``nn_impl="values_b16"``), on
    the same kernel (its ``t3t_lane_mutual_bf16_cross`` entry for the
    latter).

A wrapper given CPU tensors runs the plain PyTorch version (ops/nn.py,
chunked over the pair dimension); given CUDA tensors it launches its kernel
or raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.csrc import INT, PTR, Kernel, check_cuda_tensors, check_dtype, dispatch
from tpu3dm_torch.ops.nn import (
    FPFH_DIM,
    SMALL_D_MAX,
    WIDE_MAX_D,
    _byte_mask,
    _ptr,
    _sq_norms,
    bf16_round,
    lane_slices,
    nn_mutual_mask,
    nn_search_dense,
)

LANE_NN = Kernel(
    "lane_nn_smalld", "lane_nn.cu", "t3t_lane_nn_smalld",
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT],
)
LANE_NN_WIDE = Kernel(
    "lane_nn_wide", "lane_nn.cu", "t3t_lane_nn_wide", [PTR] * 7 + [INT] * 4,
)
LANE_MUTUAL = Kernel(
    "lane_mutual", "lane_mutual.cu", "t3t_lane_mutual", [PTR] * 9 + [INT] * 3,
)
LANE_MUTUAL_BF16_CROSS = Kernel(
    "lane_mutual_bf16_cross", "lane_mutual.cu", "t3t_lane_mutual_bf16_cross",
    [PTR] * 9 + [INT] * 3,
)
# Kernel 2 keeps a lane's row lists (12 bytes a query row, 8 a target row) in
# shared memory beside ~54 KB of tiles up to this many bytes (8192 rows a
# side), within the H100's 227 KB a block; a larger lane keeps them in a
# device-memory scratch.
MUTUAL_SHARED_LIST_BYTES = 20 * 8192


def _check_batched(where: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 3 or y.ndim != 3 or x.shape[0] != y.shape[0] or x.shape[2] != y.shape[2]:
        raise ValueError(f"{where}: expected [B, M, d] and [B, N, d], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")


def nn_search_lane_plain(query, target, query_mask=None, target_mask=None):
    """Plain PyTorch version of ``nn_search_lane`` (any device), over slabs
    of lanes and, where one lane's queries would pass 256 MB of entries, of
    its query rows."""
    b, m, n = query.shape[0], query.shape[1], target.shape[1]
    rows = max(1, min(m, (1 << 26) // max(n, 1)))
    d2s, idxs = [], []
    for s in lane_slices(b, rows * n):
        tm = None if target_mask is None else target_mask[s]
        parts = [nn_search_dense(query[s, r:r + rows], target[s], None, tm)
                 for r in range(0, m, rows)]
        d2s.append(torch.cat([d for d, _ in parts], dim=1))
        idxs.append(torch.cat([i for _, i in parts], dim=1))
    return torch.cat(d2s), torch.cat(idxs)


def nn_search_lane(
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN per pair lane (the JAX ``nn_search`` contract, batched).

    Args:
      query: [B, M, d] float32; target: [B, N, d] float32.  On CUDA d = 3 or
        8 <= d <= 64 (the kernels' widths); other widths raise there.
      query_mask: [B, M] bool or None.  Masked queries get unspecified
        results, as in JAX: the plain version and the d != 33 kernels
        compute them, the d = 33 kernel skips them (idx 0).
      target_mask: [B, N] bool or None; masked targets never win.

    Returns (d2 [B, M] float32, idx [B, M] int32), ties to the smaller index.
    For d < 8, d2 sums the squared differences; for d >= 8 it is
    max(min_j (|t_j|^2 - 2 q.t_j) + |q|^2, 0), as in the TPU kernels.
    """
    _check_batched("nn_search_lane", query, target)
    if dispatch("nn_search_lane", query, target, query_mask, target_mask) == "cpu":
        return nn_search_lane_plain(query, target, None, target_mask)
    b, m, n, d = query.shape[0], query.shape[1], target.shape[1], query.shape[2]
    where = "nn_search_lane"
    check_dtype(where, torch.float32, query=query, target=target)
    out = torch.empty((b, m), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, m), dtype=torch.int32, device=query.device)
    if d < SMALL_D_MAX:
        if d != 3:
            raise NotImplementedError(f"{where}: below d = {SMALL_D_MAX} the kernel takes d = 3, "
                                      f"got {d}")
        dev = check_cuda_tensors(where, b, query=query, target=target, d2=out, idx=idx)
        target_mask = _byte_mask(where, target_mask, (b, n), dev)
        LANE_NN.launch(
            dev, query.data_ptr(), target.data_ptr(), _ptr(target_mask),
            out.data_ptr(), idx.data_ptr(), b, m, n,
        )
        return out, idx
    if d > WIDE_MAX_D:
        raise NotImplementedError(f"{where}: the kernel takes d <= {WIDE_MAX_D}, got {d}")
    tsq = _sq_norms(target, target_mask)
    dev = check_cuda_tensors(where, b, query=query, target=target, tsq=tsq, part=out, idx=idx)
    query_mask = _byte_mask(where, query_mask, (b, m), dev)
    target_mask = _byte_mask(where, target_mask, (b, n), dev)
    LANE_NN_WIDE.launch(
        dev, query.data_ptr(), target.data_ptr(), tsq.data_ptr(), _ptr(query_mask),
        _ptr(target_mask), out.data_ptr(), idx.data_ptr(), b, m, n, d,
    )
    return torch.clamp_min(out + torch.sum(query * query, dim=-1), 0.0), idx


def nn_mutual_lane_plain(a, b, mask_a=None, mask_b=None, *, approx=False, cross_bf16=False):
    """Plain PyTorch version of ``nn_mutual_mask_batched`` (any device)."""
    nb, na, nbt = a.shape[0], a.shape[1], b.shape[1]
    idxs, muts = [], []
    for s in lane_slices(nb, na * nbt):
        idx, mut = nn_mutual_mask(
            a[s], b[s],
            None if mask_a is None else mask_a[s],
            None if mask_b is None else mask_b[s],
            approx=approx, cross_bf16=cross_bf16,
        )
        idxs.append(idx)
        muts.append(mut)
    return torch.cat(idxs), torch.cat(muts)


def nn_mutual_mask_lane(
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
    *,
    approx: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward NN + mutuality mask per pair lane (the JAX lane wrapper's
    contract, batched): ``nn_mutual_mask_batched`` in fp32.

    ``approx`` is accepted for API parity and ignored: the computation is
    fp32, as the TPU kernel's is.
    """
    del approx
    return nn_mutual_mask_batched(a, b, mask_a, mask_b)


def nn_mutual_mask_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
    *,
    approx: bool = False,
    cross_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward NN + mutuality mask per pair lane (the JAX ``nn_mutual_mask``
    contract, batched).

    Args:
      a: [B, Na, 33] float32 query features; b: [B, Nb, 33] target features.
      mask_a, mask_b: [B, Na] / [B, Nb] bool or None.
      approx: the cross of bf16-rounded features, accumulated in fp32 (the
        norms stay those of the fp32 features).  Products of bf16 values are
        exact in fp32, so on CUDA kernel 2 computes it on the rounded
        features; only the order of the fp32 sums differs from JAX.
      cross_bf16: round the cross to bf16 before the distance is formed
        (kernel 2's bf16-cross entry; JAX's
        ``nn_mutual_vals(cross_dtype=bf16)``).

    Returns (idx_fwd [B, Na] int32, mutual [B, Na] bool).  On exact ties
    every tying row passes the mutuality test.  A masked row is never
    mutual; its idx is unspecified (the kernel writes 0).
    """
    where = "nn_mutual_mask_batched"
    _check_batched(where, a, b)
    if dispatch(where, a, b, mask_a, mask_b) == "cpu":
        return nn_mutual_lane_plain(a, b, mask_a, mask_b, approx=approx, cross_bf16=cross_bf16)
    return _mutual_kernel(where, a, b, mask_a, mask_b, approx, cross_bf16)


def _mutual_kernel(where, a, b, mask_a, mask_b, approx, cross_bf16):
    """Kernel 2 (or its bf16-cross entry) on CUDA tensors."""
    if a.shape[-1] != FPFH_DIM:
        raise NotImplementedError(f"{where}: the kernel takes d = {FPFH_DIM}, got {a.shape[-1]}")
    check_dtype(where, torch.float32, a=a, b=b)
    nl, na, nb = a.shape[0], a.shape[1], b.shape[1]
    # The norms keep BIG at masked rows: a lane with no valid target computes
    # the biased entries, as the plain version does.
    asq = _sq_norms(a, mask_a)
    bsq = _sq_norms(b, mask_b)
    if approx:
        a, b = bf16_round(a), bf16_round(b)
    idx = torch.empty((nl, na), dtype=torch.int32, device=a.device)
    mutual = torch.empty((nl, na), dtype=torch.bool, device=a.device)
    dev = check_cuda_tensors(where, nl, a=a, b=b, asq=asq, bsq=bsq, idx=idx, mutual=mutual)
    mask_a = _byte_mask(where, mask_a, (nl, na), dev)
    mask_b = _byte_mask(where, mask_b, (nl, nb), dev)
    scratch = None
    if 12 * na + 8 * nb > MUTUAL_SHARED_LIST_BYTES:
        scratch = torch.empty((nl, 3 * na + 2 * nb), dtype=torch.int32, device=dev)
    kernel = LANE_MUTUAL_BF16_CROSS if cross_bf16 else LANE_MUTUAL
    kernel.launch(
        dev, a.data_ptr(), b.data_ptr(), asq.data_ptr(), bsq.data_ptr(), _ptr(mask_a),
        _ptr(mask_b), idx.data_ptr(), mutual.data_ptr(), _ptr(scratch), nl, na, nb,
    )
    return idx, mutual
