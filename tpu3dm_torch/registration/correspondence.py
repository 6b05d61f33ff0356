"""Feature-space correspondences (port of tpu3dm/registration/correspondence.py).

Top-1 NN in FPFH space, optionally mutual: a pair survives when each is the
other's nearest neighbour.  Up to DENSE_MAX_ENTRIES entries both directions
come from one distance matrix; above it from two tiled searches (kernel
csrc/nn_tiled.cu, d >= 8, on CUDA).

Noise injection (robustness testing, the reference's ransac.py:89-99):
with ``noise_ratio`` r > 0 each valid pair is replaced, with probability
r / (1 + r), by a random (source, target) index pair in [0, n_src) x
[0, n_tgt), the valid counts of the two clouds (their valid rows come first
in a preprocessed cloud), so the mixture matches the reference's appended
and shuffled bogus pairs without a dynamic shape.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.ops.nn import nn_mutual, nn_search


def feature_correspondences(
    src: PointCloud,
    tgt: PointCloud,
    *,
    mutual_filter: bool = False,
    noise_ratio: float = 0.0,
    noise_draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Correspondence pairs from FPFH nearest neighbours.

    With ``noise_ratio`` > 0 the pairs are corrupted as the module says,
    from ``noise_draws`` = (uniform [Ns] float32, source indices [Ns],
    target indices [Ns]) (JAX draws ``uniform(k1, (Ns,))``, ``randint(k2,
    (Ns,), 0, n_src)`` and ``randint(k3, (Ns,), 0, n_tgt)`` from
    ``split(key, 3)``), or ``correspondence_noise_draws`` from
    ``generator`` when None.

    Returns (pairs [Ns, 2] int64 rows [src_idx, tgt_idx], valid [Ns] bool).
    """
    ns = src.capacity
    rows = torch.arange(ns, device=src.points.device)
    valid = src.mask
    if mutual_filter:
        idx_fwd, idx_bwd = nn_mutual(src.features, tgt.features, src.mask, tgt.mask)
        idx_fwd = idx_fwd.to(torch.int64)
        valid = valid & (idx_bwd.to(torch.int64)[idx_fwd] == rows)
    else:
        _, idx_fwd = nn_search(src.features, tgt.features, src.mask, tgt.mask)
        idx_fwd = idx_fwd.to(torch.int64)
    pairs = torch.stack([rows, idx_fwd], dim=1)
    if noise_ratio > 0.0:
        if noise_draws is None:
            noise_draws = correspondence_noise_draws(
                ns, int(torch.sum(src.mask)), int(torch.sum(tgt.mask)), generator)
        u, rand_src, rand_tgt = (x.to(rows.device) for x in noise_draws)
        if not (u.shape == rand_src.shape == rand_tgt.shape == (ns,)):
            raise ValueError(f"noise_draws must be three [{ns}] tensors")
        r = np.float32(noise_ratio)
        corrupt = (u < float(r / (np.float32(1.0) + r))) & valid
        noisy = torch.stack([rand_src, rand_tgt], dim=1).to(torch.int64)
        pairs = torch.where(corrupt[:, None], noisy, pairs)
    return pairs, valid


def correspondence_noise_draws(
    ns: int, n_src: int, n_tgt: int, generator: torch.Generator | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draws of ``feature_correspondences``' noise injection, on the
    generator's device (the CPU when None): (uniform [ns], source indices in
    [0, max(n_src, 1)), target indices in [0, max(n_tgt, 1)))."""
    dev = None if generator is None else generator.device
    u = torch.rand((ns,), generator=generator, dtype=torch.float32, device=dev)
    rand_src = torch.randint(0, max(n_src, 1), (ns,), generator=generator, device=dev)
    rand_tgt = torch.randint(0, max(n_tgt, 1), (ns,), generator=generator, device=dev)
    return u, rand_src, rand_tgt


def gather_pairs(
    src: PointCloud, tgt: PointCloud, pairs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (p, q) points of the correspondence pairs."""
    return src.points[pairs[:, 0]], tgt.points[pairs[:, 1]]
