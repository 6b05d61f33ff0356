"""Threaded host ingest (port of tpu3dm/io/loader.py: ``voxel_downsample_many``).

The host voxel grid of each cloud (``preprocess/voxel.py:voxel_means``, the
C++ grid of csrc/host.cpp reached through ctypes, which releases the GIL
during the call) runs on a thread pool, so OS threads give real parallelism
with no pickling.  Outputs are identical to the serial path: each worker
runs the same pure function on one cloud and order is kept by index.
"""

from __future__ import annotations

import concurrent.futures as _cf
import os

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.csrc import host_library
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host


def _n_workers(workers: int | None, n_items: int) -> int:
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    return max(1, min(workers, n_items))


def voxel_downsample_many(
    clouds: list,
    voxel_size: float,
    *,
    pad_multiple: int = 256,
    workers: int | None = None,
    device=None,
) -> list[PointCloud]:
    """``voxel_downsample_host`` of many [N_i, 3] host clouds on a thread
    pool; results in input order, on ``device`` (None means CUDA and raises
    without it)."""
    if not clouds:
        return []

    def one(c):
        return voxel_downsample_host(c, voxel_size, pad_multiple, device=device)

    nw = _n_workers(workers, len(clouds))
    host_library()  # built and loaded once, before the threads share it
    if nw == 1:
        return [one(c) for c in clouds]
    with _cf.ThreadPoolExecutor(max_workers=nw) as ex:
        return list(ex.map(one, clouds))
