"""Ingest + preprocessing (port of tpu3dm/preprocess/pipeline.py).

``preprocess_points`` (one cloud) and ``preprocess_points_batch`` (many,
the down features batched over clouds): host voxel downsample, then
``down_features``: with the default radii and caps ONE k = fpfh_max_nn
top-k scan feeds both the normals (first normal_max_nn slots, re-masked by
the normal radius) and the 33-D FPFH; other configurations (a cap of 0, or
normal_radius > fpfh_radius) run each stage on its own, as JAX does.  The
full-resolution cloud gets its own normals at the normal radius, as JAX's
``preprocess_points`` gives them: every neighbour in the radius
(``estimate_normals``) when ``full_normal_max_nn`` is 0, else the nearest
``full_normal_max_nn`` (``estimate_normals_capped``).  Optional Gaussian
noise goes on the downsampled points after the features, as the reference
adds it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core.cloud import PAD_SENTINEL, PointCloud, from_numpy, round_up
from tpu3dm_torch.core.config import PreprocessConfig
from tpu3dm_torch.io.loader import voxel_downsample_many
from tpu3dm_torch.ops.topk import nn_topk
from tpu3dm_torch.preprocess.fpfh import compute_fpfh, compute_fpfh_capped, fpfh_from_knn
from tpu3dm_torch.preprocess.normals import (
    estimate_normals,
    estimate_normals_capped,
    normals_from_knn,
)
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host


@dataclasses.dataclass
class ProcessedCloud:
    """A cloud at two resolutions: ``full`` (with normals) and ``down``
    (downsampled, with normals and FPFH features)."""

    full: PointCloud
    down: PointCloud
    voxel_size: float


def down_features(
    down: PointCloud,
    normal_radius: float,
    fpfh_radius: float,
    *,
    normal_max_nn: int,
    fpfh_max_nn: int,
    share_knn: bool,
) -> PointCloud:
    """Normals + FPFH of one downsampled cloud ([N, 3] points), or of a batch
    of clouds ([B, N, 3]).

    With ``share_knn`` (the caller certifies normal_radius <= fpfh_radius)
    and 0 < normal_max_nn <= fpfh_max_nn (the reference's 2 * voxel <= 5 *
    voxel and 30 <= 100), ONE k = fpfh_max_nn top-k scan serves both: the
    slots are distance-ascending, so the first normal_max_nn re-masked by
    the normal radius are exactly the normals' hybrid-search set.
    Otherwise each stage runs on its own, as JAX's: normals from the
    max_nn nearest in the radius (``estimate_normals_capped``) or, at
    normal_max_nn = 0, from every point in it (``estimate_normals``), cloud
    by cloud; then ``compute_fpfh_capped``, or at fpfh_max_nn = 0
    ``compute_fpfh``.

    The features are computed on the cloud shifted by its centroid rounded
    to a multiple of 64: |a|^2 + |b|^2 - 2ab loses the neighbour sets to fp32
    cancellation far from the origin, and the rounding makes the shift an
    exact no-op for near-origin clouds.  The returned cloud keeps its
    original points.
    """
    orig = down
    ctr = torch.round(down.centroid() / 64.0) * 64.0
    down = down.with_(points=down.points - ctr[..., None, :])
    if share_knn and 0 < normal_max_nn <= fpfh_max_nn:
        pts = torch.where(down.mask[..., None], down.points, PAD_SENTINEL)
        n = pts.shape[-2]
        k_n = min(normal_max_nn, n)
        d2, idx, valid = nn_topk(
            pts, pts, down.mask, down.mask, k=min(fpfh_max_nn, n), radius=fpfh_radius,
            self_pairs=True,
        )
        r2_n = float(torch.tensor(normal_radius, dtype=torch.float32) ** 2)
        nvalid = valid[..., :k_n] & (d2[..., :k_n] <= r2_n)
        down = normals_from_knn(down, idx[..., :k_n], nvalid)
        featured = fpfh_from_knn(down, d2, idx, valid)
    else:
        if normal_max_nn > 0:
            def normals(pc):
                return estimate_normals_capped(pc, normal_radius, max_nn=normal_max_nn)
        else:
            def normals(pc):
                return estimate_normals(pc, normal_radius)
        if down.points.ndim == 2:
            down = normals(down)
        else:
            down = down.with_(normals=torch.stack([
                normals(PointCloud(*(getattr(down, f)[b] for f in
                                     ("points", "mask", "normals", "features")))).normals
                for b in range(down.points.shape[0])]))
        if fpfh_max_nn > 0:
            featured = compute_fpfh_capped(down, fpfh_radius, max_nn=fpfh_max_nn)
        else:
            featured = compute_fpfh(down, fpfh_radius)
    return orig.with_(normals=featured.normals, features=featured.features)


def _noise_device(
    down: PointCloud, sigma: float, noise: torch.Tensor | None = None, generator=None
) -> PointCloud:
    """``down`` with sigma x ``noise`` added to its valid points and its
    padding rows kept at 0 (JAX's ``_noise_device``).

    ``noise`` holds standard normal draws of the points' shape [cap, 3]
    (JAX draws ``jax.random.normal(key, (cap, 3))``); when None they are
    drawn on the CPU from ``generator`` (torch's default generator when
    None).
    """
    shape = tuple(down.points.shape)
    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise must be {list(shape)}, got {list(noise.shape)}")
    noise = noise.to(device=down.points.device, dtype=torch.float32)
    noisy = down.points + noise * float(np.float32(sigma))
    return down.with_(points=torch.where(down.mask[..., None], noisy, 0.0))


def _full_normals(full: PointCloud, config: PreprocessConfig) -> PointCloud:
    if config.full_normal_max_nn > 0:
        return estimate_normals_capped(full, config.normal_radius,
                                       max_nn=config.full_normal_max_nn)
    return estimate_normals(full, config.normal_radius)


def preprocess_points(
    points: np.ndarray,
    config: PreprocessConfig = PreprocessConfig(),
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device=None,
) -> ProcessedCloud:
    """Voxel downsample on the host, then the downsampled cloud's normals +
    FPFH and the full cloud's normals on ``device``; with
    ``config.noise_sigma`` > 0, Gaussian noise on the downsampled points
    after the features (``_noise_device``: draws ``noise`` [cap, 3] or from
    ``generator``), as the reference adds it.

    ``device=None`` means CUDA, and raises when CUDA is absent.
    """
    dev = resolve_device(device)
    full = from_numpy(points, device=dev)
    down = voxel_downsample_host(points, config.voxel_size, device=dev)
    down = down_features(
        down,
        config.normal_radius,
        config.fpfh_radius,
        normal_max_nn=config.normal_max_nn,
        fpfh_max_nn=config.fpfh_max_nn,
        share_knn=config.normal_radius <= config.fpfh_radius,
    )
    if config.noise_sigma > 0.0:
        down = _noise_device(down, config.noise_sigma, noise, generator)
    return ProcessedCloud(full=_full_normals(full, config), down=down,
                          voxel_size=config.voxel_size)


def preprocess_points_batch(
    clouds: list,
    config: PreprocessConfig = PreprocessConfig(),
    *,
    noise=None,
    generator: torch.Generator | None = None,
    workers: int | None = None,
    full_normals: bool = True,
    down_cap: int | None = None,
    device=None,
) -> list[ProcessedCloud]:
    """Preprocess many [N_i, 3] host clouds, the down features batched over
    clouds (JAX's ``preprocess_points_batch``).

    The host voxel grids run on ``workers`` threads
    (``io.loader.voxel_downsample_many``).  Every downsampled cloud is padded
    to one capacity, the largest round_up(n_valid, 256) of the batch, raised
    to ``down_cap`` (a streaming caller keeps one capacity across windows),
    and ``down_features`` runs over [chunk, cap_d, 3] batches whose size
    follows JAX's memory rule: 96 Mi / cap_d^2 clouds, and at most 64 x
    20480 / cap_f with ``full_normals``.  Each cloud's down normals and
    features are those of per-cloud ``preprocess_points`` at the same
    capacity.

    ``full`` is padded to cap_f, the largest round_up(N_i, 256).
    ``full_normals=False`` skips the full-resolution normals (the dominant
    ingest cost; the batched registration reads only ``down``) and returns
    ``full`` as a host-resident cloud: CPU tensors, zero normals.  With
    ``full_normals`` they run cloud by cloud, their query and target blocks
    bounding the memory.

    ``config.noise_sigma`` > 0 adds noise to each cloud's down points:
    cloud i takes ``noise[i]`` ([n_clouds, cap_d, 3] or a sequence of
    [cap_d, 3]; JAX draws cloud i's along ``fold_in(key, i)``), or draws
    from ``generator`` cloud after cloud.

    ``device=None`` means CUDA, and raises when CUDA is absent.
    """
    dev = resolve_device(device)
    if not clouds:
        return []
    downs = voxel_downsample_many(clouds, config.voxel_size, workers=workers, device="cpu")
    counts = [int(d.mask.sum()) for d in downs]
    cap_d = max(round_up(n, 256) for n in counts)
    if down_cap is not None:
        cap_d = max(cap_d, down_cap)
    cap_f = max(round_up(np.asarray(p).shape[0], 256) for p in clouds)
    n_clouds = len(clouds)
    chunk = max(1, min(n_clouds, (96 * 1024 * 1024) // (cap_d * cap_d)))
    if full_normals:
        chunk = max(1, min(chunk, (64 * 20480) // cap_f))

    points = torch.zeros((n_clouds, cap_d, 3), dtype=torch.float32)
    mask = torch.zeros((n_clouds, cap_d), dtype=torch.bool)
    for i, (d, n) in enumerate(zip(downs, counts)):
        points[i, :n] = d.points[:n]
        mask[i, :n] = True
    points, mask = points.to(dev), mask.to(dev)
    normals, features = [], []
    for lo in range(0, n_clouds, chunk):
        sl = slice(lo, lo + chunk)
        part = down_features(
            PointCloud(points=points[sl], mask=mask[sl], normals=torch.zeros_like(points[sl]),
                       features=torch.zeros(points[sl].shape[:-1] + (0,), device=dev)),
            config.normal_radius,
            config.fpfh_radius,
            normal_max_nn=config.normal_max_nn,
            fpfh_max_nn=config.fpfh_max_nn,
            share_knn=config.normal_radius <= config.fpfh_radius,
        )
        normals.append(part.normals)
        features.append(part.features)
    normals, features = torch.cat(normals), torch.cat(features)

    out = []
    for i, raw in enumerate(clouds):
        down = PointCloud(points=points[i], mask=mask[i], normals=normals[i],
                          features=features[i])
        if config.noise_sigma > 0.0:
            down = _noise_device(down, config.noise_sigma, None if noise is None else noise[i],
                                 generator)
        if full_normals:
            full = _full_normals(from_numpy(raw, capacity=cap_f, device=dev), config)
        else:
            full = from_numpy(raw, capacity=cap_f, device="cpu")
        out.append(ProcessedCloud(full=full, down=down, voxel_size=config.voxel_size))
    return out


def load_cloud(
    path,
    config: PreprocessConfig = PreprocessConfig(),
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device=None,
) -> ProcessedCloud:
    """Read a PLY file and preprocess it (``preprocess_points``).

    Raises FileNotFoundError for a missing file, TypeError for a name
    without the .ply suffix, and ValueError (``io.ply.PlyError``) for a
    malformed file, as JAX's ``load_cloud`` does.
    """
    from pathlib import Path

    from tpu3dm_torch.io.ply import read_ply

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Ply file not found: {path}")
    if path.suffix.lower() != ".ply":
        raise TypeError(f"File is not a ply file: {path}")
    return preprocess_points(read_ply(path)["points"], config, noise=noise, generator=generator,
                             device=device)
