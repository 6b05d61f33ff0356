"""Nearest-neighbour search (port of tpu3dm/ops/nn.py: dense and tiled tiers).

  - ``nn_search_dense``: the [..., Nq, Nt] distance matrix materialized; the
    plain version the lane kernels (ops/nn_lane.py) are held against.
  - ``nn_search_tiled``: the counterpart of ``nn_search_pallas``, for sets
    too large to materialize.  On CUDA it launches csrc/nn_tiled.cu, which
    replaces ``_nn_kernel_smalld`` (d < 8; built for d = 3, the only width
    of the port's paths) and ``_nn_kernel`` (d >= 8); on the CPU it runs
    ``nn_search_tiled_plain``, the same arithmetic chunked over queries.
  - ``nn_search`` and ``nn_mutual``: dense up to DENSE_MAX_ENTRIES entries,
    tiled above, as in JAX.  The tensors' device picks plain version or
    kernel; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from tpu3dm_torch.csrc import INT, PTR, Kernel, check_cuda_tensors, check_dtype, dispatch

# Squared norm given to masked rows and columns: they never win a minimum,
# and BIG + BIG stays finite in fp32.
BIG = 1.0e30
# Below this feature width the distance is expanded per dimension
# (sum_d (q_d - t_d)^2); at and above it through a matmul cross term.
SMALL_D_MAX = 8
# Up to this many query x target entries the distance matrix is materialized
# (16M entries = 64 MB fp32); above it the tiled search runs.
DENSE_MAX_ENTRIES = 1 << 24

NN_TILED_SMALLD = Kernel(
    "nn_tiled_smalld", "nn_tiled.cu", "t3t_nn_tiled_smalld", [PTR] * 6 + [INT] * 2,
)
NN_TILED_WIDE = Kernel(
    "nn_tiled_wide", "nn_tiled.cu", "t3t_nn_tiled_wide", [PTR] * 7 + [INT] * 3,
)
WIDE_MAX_D = 64  # the wide kernel's staged feature width
FPFH_DIM = 33  # the width whose kernels take the query mask (csrc/fpfh_search.cuh)


def lane_slices(n_lanes: int, entries_per_lane: int, max_entries: int = 1 << 26):
    """Slices of the leading dimension whose dense temporaries stay under
    ``max_entries`` fp32 entries (256 MB), so a plain version never builds
    a tensor of many GB."""
    step = max(1, max_entries // max(entries_per_lane, 1))
    return [slice(lo, min(lo + step, n_lanes)) for lo in range(0, n_lanes, step)]


def _sq_norms(points: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Squared norms with masked rows pushed unreachably far away."""
    sq = torch.sum(points * points, dim=-1)
    if mask is not None:
        sq = torch.where(mask, sq, BIG)
    return sq


def nn_search_dense(
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN of each query row among the valid targets ([..., Nq, d] x
    [..., Nt, d]).  Masked queries get arbitrary results.

    Returns (d2 [..., Nq] float32, idx [..., Nq] int32); ties go to the
    smaller target index.  For d < SMALL_D_MAX the distance is the direct
    sum of squared differences plus a 0 / BIG target bias, each step rounded
    on its own — the arithmetic of the 3-D CUDA kernels.
    """
    d = query.shape[-1]
    if d < SMALL_D_MAX:
        bias = torch.zeros(target.shape[:-1], dtype=query.dtype, device=query.device)
        if target_mask is not None:
            bias = torch.where(target_mask, bias, BIG)
        d2 = bias[..., None, :]
        for k in range(d):
            diff = query[..., :, k, None] - target[..., None, :, k]
            d2 = d2 + diff * diff
        idx = torch.argmin(d2, dim=-1).to(torch.int32)
        return torch.clamp_min(torch.amin(d2, dim=-1), 0.0), idx
    tsq = _sq_norms(target, target_mask)
    cross = query @ target.transpose(-1, -2)
    d2 = tsq[..., None, :] - 2.0 * cross
    idx = torch.argmin(d2, dim=-1).to(torch.int32)
    best = torch.amin(d2, dim=-1) + torch.sum(query * query, dim=-1)
    return torch.clamp_min(best, 0.0), idx


def nn_search_tiled_plain(query, target, query_mask=None, target_mask=None):
    """Plain PyTorch version of ``nn_search_tiled`` (any device):
    ``nn_search_dense`` over chunks of queries, so no temporary exceeds 256 MB.

    The TPU kernels' arithmetic: for d < 8, bias + sum_k (q_k - t_k)^2, the
    true squared distance; for d >= 8, min_j (tsq_j - 2 q.t_j), then + |q|^2
    and max(., 0).  A running minimum with the first index over target tiles
    in order is the first argmin of the whole row, which torch.argmin gives.
    Masked queries are computed like valid ones (their results are
    unspecified, as in JAX).
    """
    del query_mask
    d2s, idxs = [], []
    for s in lane_slices(query.shape[0], target.shape[0]):
        d2, idx = nn_search_dense(query[s], target, None, target_mask)
        d2s.append(d2)
        idxs.append(idx)
    return torch.cat(d2s), torch.cat(idxs)


def _byte_mask(where: str, mask: torch.Tensor | None, shape: tuple[int, ...],
               dev: torch.device) -> torch.Tensor | None:
    """A bool mask of ``shape`` for a kernel that reads it a byte at a time
    (any offset will do), made contiguous; None stays None (every row valid)."""
    if mask is None:
        return None
    check_dtype(where, torch.bool, mask=mask)
    if mask.shape != shape or mask.device != dev:
        raise ValueError(f"{where}: mask {tuple(mask.shape)} on {mask.device} does not match "
                         f"{shape} rows on {dev}")
    return mask.contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def nn_search_tiled(
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN without materializing the distance matrix (the JAX
    ``nn_search_pallas`` contract).

    Args:
      query: [Nq, d] float32; target: [Nt, d] float32.  On CUDA d = 3 or
        8 <= d <= 64 (the kernels' widths); other widths raise there.
      query_mask: [Nq] bool or None.  Masked queries get unspecified
        results, as in JAX: the plain version and the kernel at d != 3, 33
        compute them, the d = 3 and d = 33 kernels skip them (idx 0,
        d2 = BIG).
      target_mask: [Nt] bool or None; masked targets never win.

    Returns (d2 [Nq] float32, idx [Nq] int32), ties to the smaller index.
    """
    where = "nn_search_tiled"
    if query.ndim != 2 or target.ndim != 2 or query.shape[1] != target.shape[1]:
        raise ValueError(f"{where}: expected [Nq, d] and [Nt, d], got "
                         f"{tuple(query.shape)} and {tuple(target.shape)}")
    if dispatch(where, query, target, query_mask, target_mask) == "cpu":
        return nn_search_tiled_plain(query, target, query_mask, target_mask)
    nq, d = query.shape
    nt = target.shape[0]
    check_dtype(where, torch.float32, query=query, target=target)
    out = torch.empty((nq,), dtype=torch.float32, device=query.device)
    idx = torch.empty((nq,), dtype=torch.int32, device=query.device)
    if d < SMALL_D_MAX:
        if d != 3:
            raise NotImplementedError(f"{where}: below d = {SMALL_D_MAX} the kernel takes d = 3, "
                                      f"got {d}")
        dev = check_cuda_tensors(where, 1, query=query, target=target, d2=out, idx=idx)
        query_mask = _byte_mask(where, query_mask, (nq,), dev)
        target_mask = _byte_mask(where, target_mask, (nt,), dev)
        NN_TILED_SMALLD.launch(
            dev, query.data_ptr(), target.data_ptr(), _ptr(query_mask), _ptr(target_mask),
            out.data_ptr(), idx.data_ptr(), nq, nt,
        )
        return out, idx
    if d > WIDE_MAX_D:
        raise NotImplementedError(f"{where}: the kernel takes d <= {WIDE_MAX_D}, got {d}")
    tsq = _sq_norms(target, target_mask)
    dev = check_cuda_tensors(where, 1, query=query, target=target, tsq=tsq, part=out, idx=idx)
    if d == FPFH_DIM:
        query_mask = _byte_mask(where, query_mask, (nq,), dev)
        target_mask = _byte_mask(where, target_mask, (nt,), dev)
    else:
        query_mask = target_mask = None  # nn_wide.cuh computes every row; tsq masks targets
    NN_TILED_WIDE.launch(
        dev, query.data_ptr(), target.data_ptr(), tsq.data_ptr(), _ptr(query_mask),
        _ptr(target_mask), out.data_ptr(), idx.data_ptr(), nq, nt, d,
    )
    return torch.clamp_min(out + torch.sum(query * query, dim=-1), 0.0), idx


def nn_search(
    query: torch.Tensor,
    target: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Size-adaptive top-1 NN: the dense search up to DENSE_MAX_ENTRIES
    entries, the tiled one (kernels on CUDA) above.  Queries [..., Nq, d]
    against one target [Nt, d] pick the tier by Nq x Nt; the tiled tier
    then searches all their rows at once."""
    if query.shape[-2] * target.shape[-2] <= DENSE_MAX_ENTRIES:
        return nn_search_dense(query, target, query_mask, target_mask)
    if query.ndim > 2 and target.ndim == 2:
        rows = query.shape[:-1]
        if query_mask is not None:
            query_mask = query_mask.expand(rows).reshape(-1)
        d2, idx = nn_search_tiled(query.reshape(-1, query.shape[-1]), target, query_mask,
                                  target_mask)
        return d2.reshape(rows), idx.reshape(rows)
    return nn_search_tiled(query, target, query_mask, target_mask)


def nn_mutual(
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward top-1 NN (fp32).

    Up to DENSE_MAX_ENTRIES entries from ONE [Na, Nb] matrix with both
    squared norms added, reduced along each axis; above it two tiled
    searches, a -> b and b -> a.

    Returns (idx_fwd [..., Na], idx_bwd [..., Nb]) int32: for each a its
    nearest b, and for each b its nearest a (first index on ties).
    """
    if a.shape[-2] * b.shape[-2] <= DENSE_MAX_ENTRIES:
        asq = _sq_norms(a, mask_a)
        bsq = _sq_norms(b, mask_b)
        d2 = asq[..., :, None] + bsq[..., None, :] - 2.0 * (a @ b.transpose(-1, -2))
        idx_fwd = torch.argmin(d2, dim=-1).to(torch.int32)
        idx_bwd = torch.argmin(d2, dim=-2).to(torch.int32)
        return idx_fwd, idx_bwd
    _, idx_fwd = nn_search(a, b, mask_a, mask_b)
    # No query mask backward: every b row gets its nearest a, masked ones
    # too, as in the plain version (a kernel skips masked query rows).  A
    # caller that reads idx_bwd[idx_fwd] reads a masked b row when every b is
    # masked, and then gets the same answer on the card as on the CPU.
    _, idx_bwd = nn_search(b, a, None, mask_a)
    return idx_fwd, idx_bwd


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as XLA converts) and back to fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., Na, Nb] dots of a [..., Na, d] and b [..., Nb, d], summed from 0
    over k = 0 .. d-1 in order: each step one product and one rounded add.
    Where every product is exact in fp32 (bf16 inputs) this is the fmaf
    chain of csrc/fpfh_tile.cuh, bit for bit."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc += a[..., :, None, k] * b[..., None, :, k]
    return acc


def nn_mutual_mask(
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
    *,
    approx: bool = False,
    cross_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward NN + mutuality mask from ONE distance matrix, min-only.

    d2 = (|a|^2 + |b|^2) - 2 cross, the norms from the fp32 features (BIG at
    masked rows).  Row i is mutual iff its best distance is the best anyone
    achieves to its chosen column: d2[i, idx[i]] <= colmin[idx[i]].  On
    exact distance ties every tying row passes.

    approx: the cross of bf16-rounded features with fp32 accumulation (the
      JAX package's bf16 dot), summed in order over the features.
    cross_bf16: round the cross to bf16 before the distance is formed
      (JAX's ``nn_mutual_vals(cross_dtype=bf16)``).

    Returns (idx_fwd [..., Na] int32, mutual [..., Na] bool).
    """
    asq = _sq_norms(a, mask_a)
    bsq = _sq_norms(b, mask_b)
    if approx:
        cross = _dot_in_order(bf16_round(a), bf16_round(b))
    else:
        cross = a @ b.transpose(-1, -2)
    if cross_bf16:
        cross = bf16_round(cross)
    d2 = asq[..., :, None] + bsq[..., None, :] - 2.0 * cross
    idx = torch.argmin(d2, dim=-1)
    dmin = torch.amin(d2, dim=-1)
    colmin = torch.amin(d2, dim=-2)
    mutual = dmin <= torch.gather(colmin, -1, idx)
    if mask_a is not None:
        mutual = mutual & mask_a
    return idx.to(torch.int32), mutual
