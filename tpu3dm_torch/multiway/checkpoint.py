"""Checkpoint store for batched and multi-way registration runs (a copy of
tpu3dm/multiway/checkpoint.py).

Every completed pairwise registration is persisted as one ``.npz``
(transform, fitness, rmse, iterations); a JSON manifest and the final pose
graph solution sit beside them.  Writes are atomic (tmp + rename), so an
interrupted run never leaves a torn file.  The layout and the record format
are the JAX package's, so a store written by either package reads in the
other.

Layout of a checkpoint directory:

    manifest.json            run metadata: n_clouds, edge list, voxel size
    edge_0003_0004.npz       per-edge registration essentials
    pair_<sha1[:16]>.npz     name-keyed pair records (register_pairs_batched)
    poses.npz                final [N,4,4] poses (written once at the end)
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeRecord:
    """Persisted essentials of one pairwise registration."""

    transformation: np.ndarray  # [4,4]
    fitness: float
    inlier_rmse: float
    iterations: int


def _read_record(p: Path) -> EdgeRecord | None:
    """The record in ``p``, or None when it is absent, torn or corrupt (it
    will then be recomputed)."""
    if not p.exists():
        return None
    try:
        with np.load(p) as z:
            return EdgeRecord(
                transformation=z["transformation"],
                fitness=float(z["fitness"]),
                inlier_rmse=float(z["inlier_rmse"]),
                iterations=int(z["iterations"]),
            )
    except (OSError, KeyError, ValueError):
        return None


def _write_record(p: Path, rec: EdgeRecord) -> None:
    # The tmp name must end in .npz: np.savez appends the suffix otherwise,
    # which would break the atomic rename.
    tmp = p.with_name(p.stem + ".tmp.npz")
    np.savez(
        tmp,
        transformation=np.asarray(rec.transformation, np.float64),
        fitness=np.float64(rec.fitness),
        inlier_rmse=np.float64(rec.inlier_rmse),
        iterations=np.int64(rec.iterations),
    )
    os.replace(tmp, p)


class CheckpointStore:
    """Per-edge and per-pair npz store under one directory."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    # ---- edges -------------------------------------------------------------

    def _edge_path(self, i: int, j: int) -> Path:
        return self.dir / f"edge_{i:04d}_{j:04d}.npz"

    def get_edge(self, i: int, j: int) -> EdgeRecord | None:
        return _read_record(self._edge_path(i, j))

    def put_edge(self, i: int, j: int, rec: EdgeRecord) -> None:
        _write_record(self._edge_path(i, j), rec)

    def completed_edges(self) -> list[tuple[int, int]]:
        out = []
        for p in sorted(self.dir.glob("edge_[0-9]*_[0-9]*.npz")):
            parts = p.stem.split("_")
            if len(parts) != 3 or "." in parts[2]:
                continue  # stray .tmp.npz from an interrupted write
            out.append((int(parts[1]), int(parts[2])))
        return out

    # ---- named pair records (register_pairs_batched resume) ----------------

    @staticmethod
    def _pair_hash(name: str) -> str:
        return hashlib.sha1(name.encode()).hexdigest()[:16]

    def _pair_path(self, name: str) -> Path:
        return self.dir / f"pair_{self._pair_hash(name)}.npz"

    def get_pair(self, name: str) -> EdgeRecord | None:
        """Record of a name-keyed pair (e.g. 'src.ply\\ttgt.ply') or None.

        Keyed by a hash of the pair's identity, not its position, so a rerun
        with an edited manifest skips exactly the pairs already registered.
        """
        return _read_record(self._pair_path(name))

    def put_pair(self, name: str, rec: EdgeRecord) -> None:
        _write_record(self._pair_path(name), rec)

    # ---- manifest / poses --------------------------------------------------

    def write_manifest(self, **meta) -> None:
        tmp = self.dir / "manifest.json.tmp"
        tmp.write_text(json.dumps(meta, indent=2, default=str))
        os.replace(tmp, self.dir / "manifest.json")

    def read_manifest(self) -> dict | None:
        p = self.dir / "manifest.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def write_poses(self, poses: np.ndarray) -> None:
        tmp = self.dir / "poses.tmp.npz"
        np.savez(tmp, poses=np.asarray(poses, np.float64))
        os.replace(tmp, self.dir / "poses.npz")

    def read_poses(self) -> np.ndarray | None:
        p = self.dir / "poses.npz"
        if not p.exists():
            return None
        with np.load(p) as z:
            return z["poses"]
