"""The comparison that decides ``correct``.

Each number compared has a limit; a run is correct when every number is
finite and within its limit.  The gates' limits are the configuration's
own; the limits of the gaps to the reference are in the configuration's
``limits``, set from readings of sound runs and of the control (PERF.md).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from perfbench.lib import gate


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Verdict:
    attempted: int
    failed: int
    checks: list[Check]

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks)


def worst(values) -> float:
    """The largest of ``values`` as a float (0 for none; inf if any is not finite)."""
    a = np.asarray(list(values), np.float64)
    if a.size == 0:
        return 0.0
    return float(np.max(np.where(np.isfinite(a), a, np.inf)))


def gap_numbers(T, rmse, refs, mus, M2s) -> dict:
    """The gaps of the program's poses T [S, 4, 4] and reported inlier RMSEs
    rmse [S] to the reference's (T_ref [S, 4, 4], rmse_ref [S]) ``refs``,
    with the source clouds' moments: the rotation between the poses (deg)
    and the RMS distance between the source moved by each, worst over the
    sample; the relative gap of the inlier RMSEs, worst, at the 90th
    percentile and median over the sample.  Empty for no answers."""
    if len(refs) == 0:
        return {}
    T_ref = np.stack([r[0] for r in refs])
    rmse_ref = np.asarray([r[1] for r in refs], np.float64)
    T = np.asarray(T, np.float64)
    finite = np.isfinite(T).all(axis=(-2, -1))
    Tf = np.where(finite[:, None, None], T, np.eye(4))
    rot = np.where(finite, gate.rotation_deg(Tf, T_ref), np.inf)
    rms = np.where(finite, gate.alignment_rmse(Tf, T_ref, np.asarray(mus), np.asarray(M2s)),
                   np.inf)
    rel = np.abs(np.asarray(rmse, np.float64) - rmse_ref) / np.maximum(rmse_ref, 1e-12)
    rel = np.where(np.isfinite(rel), rel, np.inf)
    return {"pose_gap_deg": worst(rot), "pose_gap_rms": worst(rms),
            "rmse_gap_rel": worst(rel), "rmse_gap_rel_p90": float(np.percentile(rel, 90)),
            "rmse_gap_rel_median": float(np.median(rel))}


def limited(numbers: dict, limits: dict) -> list[Check]:
    """A check for each of ``numbers`` the configuration gives a limit."""
    return [Check(k, numbers[k], limits[k]) for k in numbers if k in limits]


def gate_check(missed, gate_cfg: dict) -> Check:
    """The configuration's success rate: the share of answers outside its
    gate (rotation error and alignment RMSE against the true pose), held to
    the share of misses the configuration allows."""
    missed = np.asarray(missed, bool)
    share = float(missed.mean()) if missed.size else 0.0
    return Check("gate_miss_share", share, gate_cfg["max_miss_share"])


def sample(n: int, k: int, seed: int, among=None) -> np.ndarray:
    """``k`` of ``n`` indices (all when k >= n), drawn from the seed; with a
    bool mask ``among``, only from the indices it marks."""
    pool = np.arange(n) if among is None else np.flatnonzero(np.asarray(among, bool))
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])
    return np.sort(rng.choice(pool, size=min(k, len(pool)), replace=False))
