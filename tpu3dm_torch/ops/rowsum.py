"""Sums whose order does not depend on the batch (a port-only repair).

PyTorch's reductions and batched products pick their kernel, and with it
the order of a sum, by the shape of the whole call, so a pair's sums over
its rows took other last bits as the number of pairs sharing its call
changed (JAX's serve and stream contracts say a pair's result does not
depend on its batch).  Every float sum on the fused step's path goes
through one of these instead:

  - ``row_sums``: [..., M] -> [...], lane-strided over 32 lanes, then a fixed
    xor tree (kernel csrc/row_sums.cu on CUDA, ``row_sums_plain`` on the
    CPU, the same order on both);
  - ``ordered_sum(x, dim)``: ``row_sums`` along any dim, or, for a dim of at
    most ``CHAIN_MAX`` entries, ``chain_sum``: ((x0 + x1) + x2) + ...,
    elementwise ops whose order is fixed by construction;
  - ``small_matmul`` / ``small_matvec``: products of 3x3 and 4x4 matrices
    (and of points by a rotation) as broadcast products and ``chain_sum``,
    in place of batched GEMMs whose kernel follows the batch count.

No TPU kernel is replaced: the kernel's row in PERF.md is marked
"port-only repair".
"""

from __future__ import annotations

import torch

from tpu3dm_torch.csrc import I64, INT, PTR, Kernel, check_dtype, dispatch

ROW_SUMS = Kernel("row_sums", "row_sums.cu", "t3t_row_sums", [PTR, PTR, I64, INT])

LANES = 32
# Dims this short are summed by ``chain_sum`` (elementwise adds) rather
# than by a launch with one warp a row.
CHAIN_MAX = 16


def row_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order on any device: lane l sums x[..., l], x[..., l +
    32], ... from 0.0, then the lanes fold pairwise at offsets 16, 8, 4, 2,
    1.  Zero padding adds nothing: a sum that starts at +0.0 is never -0.0."""
    m = x.shape[-1]
    k = max(1, -(-m // LANES))
    if k * LANES != m:
        x = torch.nn.functional.pad(x, (0, k * LANES - m))
    xv = x.reshape(x.shape[:-1] + (k, LANES))
    acc = torch.zeros(x.shape[:-1] + (LANES,), dtype=x.dtype, device=x.device)
    for i in range(k):
        acc = acc + xv[..., i, :]
    off = LANES // 2
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim of float32 ``x`` [..., M] in an order fixed by
    M alone.  CPU tensors take ``row_sums_plain``; CUDA tensors launch
    csrc/row_sums.cu (bit-equal to it) or raise."""
    if dispatch("row_sums", x) == "cpu":
        return row_sums_plain(x)
    check_dtype("row_sums", torch.float32, x=x)
    lead, m = x.shape[:-1], x.shape[-1]
    x = x.contiguous()
    out = torch.empty(lead, dtype=torch.float32, device=x.device)
    rows = out.numel()
    if rows == 0:
        return out
    ROW_SUMS.launch(x.device, x.data_ptr(), out.data_ptr(), rows, m)
    return out


def chain_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """((x0 + x1) + x2) + ... along ``dim``, as elementwise adds."""
    x = x.movedim(dim, -1)
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of float32 ``x`` along ``dim`` in an order that does not depend
    on the other dims: ``chain_sum`` up to CHAIN_MAX entries, else
    ``row_sums``."""
    if x.shape[dim] <= CHAIN_MAX:
        return chain_sum(x, dim)
    return row_sums(x.movedim(dim, -1))


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., n, k] @ b [..., k, m] for small k, each entry a ``chain_sum``
    over k."""
    return chain_sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def small_matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a [..., n, k] @ v [..., k], each entry a ``chain_sum`` over k."""
    return chain_sum(a * v[..., None, :], dim=-1)
