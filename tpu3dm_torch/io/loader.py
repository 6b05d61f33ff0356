"""Threaded host ingest (port of tpu3dm/io/loader.py).

  - ``read_ply_many``: PLY parses on a thread pool.  The ASCII parser is
    ``csrc/host.cpp`` reached through ctypes, which releases the GIL during
    the call, and NumPy releases it inside its binary reads, so OS threads
    give real parallelism with no pickling.
  - ``voxel_downsample_many``: the host voxel grid of each cloud
    (``preprocess/voxel.py:voxel_means``, host.cpp's grid) on the same kind
    of pool.
  - ``preprocess_files_batch``: both, then ``preprocess_points_batch``.
  - ``iter_preprocessed_windows``: a window iterator over a pair manifest
    whose producer thread ingests window i + 1 while the caller registers
    window i, so host memory holds one window and one prefetched window.

Outputs are identical to the serial path: each worker runs the same pure
function on one item, and order is kept by index.
"""

from __future__ import annotations

import concurrent.futures as _cf
import os
import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import PreprocessConfig
from tpu3dm_torch.csrc import host_library
from tpu3dm_torch.io.ply import read_ply
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host


def _n_workers(workers: int | None, n_items: int) -> int:
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    return max(1, min(workers, n_items))


def read_ply_many(
    paths: Iterable[str | Path], *, workers: int | None = None
) -> list[dict[str, np.ndarray]]:
    """Parse many PLY files on a thread pool; results in input order.

    An exception names the failing path (a bad file in a long manifest must
    name itself) and keeps its type.
    """
    paths = [Path(p) for p in paths]
    if not paths:
        return []

    def one(p):
        try:
            return read_ply(p)
        except Exception as e:  # noqa: BLE001 - re-raised with the path
            raise type(e)(f"{p}: {e}") from e

    nw = _n_workers(workers, len(paths))
    if nw == 1:
        return [one(p) for p in paths]
    with _cf.ThreadPoolExecutor(max_workers=nw) as ex:
        return list(ex.map(one, paths))


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


def preprocess_files_batch(
    paths: list[str | Path],
    config: PreprocessConfig = PreprocessConfig(),
    *,
    noise=None,
    generator: torch.Generator | None = None,
    workers: int | None = None,
    full_normals: bool = True,
    down_cap: int | None = None,
    device=None,
) -> list:
    """Threaded file parse, then ``preprocess_points_batch`` (its host voxel
    grids on ``workers`` threads, the down features batched over clouds on
    ``device``).  Returns a ``ProcessedCloud`` per path, in order; ``noise``
    / ``generator``, ``full_normals`` and ``down_cap`` as in
    ``preprocess_points_batch``.  ``device=None`` means CUDA and raises
    without it."""
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    dev = resolve_device(device)
    raws = [d["points"] for d in read_ply_many(paths, workers=workers)]
    return preprocess_points_batch(
        raws, config, noise=noise, generator=generator, workers=workers,
        full_normals=full_normals, down_cap=down_cap, device=dev,
    )


def thread_device(device) -> torch.device:
    """``resolve_device(device)`` with a CUDA index fixed in the caller's
    thread: a new thread's current device is device 0, so work handed to a
    producer thread names its device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def pair_windows(n_pairs: int, window: int) -> list[list[int]]:
    """Manifest pair indices cut into consecutive windows of ``window``."""
    if window <= 0:
        raise ValueError("window must be positive")
    return [list(range(lo, min(lo + window, n_pairs))) for lo in range(0, n_pairs, window)]


def prefetched(items: list, ingest) -> Iterator:
    """Yield ``ingest(item)`` for each item, computed one item ahead on a
    producer thread.

    The producer's exception is forwarded and raised here, in the caller's
    thread.  When the caller stops early (break, exception, close), the
    producer is told to stop and the queue is drained until it has ended,
    so no thread outlives the iterator.
    """
    q: queue.Queue = queue.Queue(maxsize=1)
    stop = threading.Event()

    def producer():
        try:
            for item in items:
                if stop.is_set():
                    return
                q.put(("ok", ingest(item)))
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            q.put(("err", e))
            return
        q.put(("done", None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "done":
                return
            if kind == "err":
                raise payload
            yield payload
    finally:
        stop.set()
        # Drain so the producer's blocked put() can observe the stop flag.
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.1)


def iter_preprocessed_windows(
    pair_paths: list[tuple[str, str]],
    config: PreprocessConfig,
    *,
    window: int,
    workers: int | None = None,
    skip_paths: set[str] | None = None,
    generator: torch.Generator | None = None,
    full_normals: bool = True,
    down_cap: int | None = None,
    device=None,
) -> Iterator[tuple[list[int], dict[str, object]]]:
    """Window iterator over a pair manifest, one window prefetched.

    Yields ``(pair_indices, {path: ProcessedCloud})`` per window of
    ``window`` pairs, each window's distinct paths through
    ``preprocess_files_batch`` in sorted order.  A producer thread ingests
    window i + 1 while the caller works on window i (prefetch depth 1:
    deeper queues would only grow host memory).

    ``skip_paths``: clouds needed only by pairs that are done already;
    they are not ingested and their entries are absent.  ``generator``
    (noise draws, with ``config.noise_sigma`` > 0) is drawn window after
    window.  The producer launches its feature work on ``device``'s current
    stream, the caller's default stream too, so the two keep their order of
    submission (None means CUDA and raises without it).
    """
    windows = pair_windows(len(pair_paths), window)
    dev = thread_device(device)
    skip = skip_paths or set()

    def ingest(idxs: list[int]) -> tuple[list[int], dict[str, object]]:
        uniq = sorted({p for i in idxs for p in pair_paths[i] if p not in skip})
        procs = preprocess_files_batch(
            uniq, config, generator=generator, workers=workers, full_normals=full_normals,
            down_cap=down_cap, device=dev,
        )
        return idxs, dict(zip(uniq, procs))

    return prefetched(windows, ingest)
