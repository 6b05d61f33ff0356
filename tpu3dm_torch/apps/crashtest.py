"""Numerical-robustness suite (port of tpu3dm/apps/crashtest.py).

The reference's crash-test categories (degenerate geometry, adversarial
noise, statistical stability, huge transforms) with real pass/fail verdicts,
run through the port's Horn fit and RANSAC on the device the caller names
(CUDA by default; ``device="cpu"`` runs the plain versions).  On CUDA the
RANSAC cases score on kernel 3's fp32 route at one lane, with zero valid
rows in ``test_zero_correspondences``.

Randomness: where JAX passes ``PRNGKey(n)``, a case takes ``sample_bits``
(``ransac_from_correspondences``' layout; the tests rebuild JAX's) or draws
from a ``torch.Generator`` seeded n.

    python -m tpu3dm_torch.apps.crashtest [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.io import synthetic
from tpu3dm_torch.registration.kabsch import fit_rigid_horn
from tpu3dm_torch.registration.ransac import ransac_from_correspondences
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


@dataclasses.dataclass
class CrashResult:
    name: str
    passed: bool
    detail: str = ""


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _finite_fit(p: np.ndarray, q: np.ndarray, device) -> tuple[bool, np.ndarray]:
    T = fit_rigid_horn(_tensor(p, device), _tensor(q, device)).cpu().numpy()
    R = T[:3, :3]
    ortho = np.abs(R @ R.T - np.eye(3)).max() < 1e-2
    return bool(np.isfinite(T).all() and ortho), T


def _ransac(p, q, valid, device, sample_bits, seed, **kw):
    gen = None if sample_bits is not None else torch.Generator().manual_seed(seed)
    return ransac_from_correspondences(
        _tensor(p, device), _tensor(q, device), torch.as_tensor(valid, device=device),
        sample_bits, gen, **kw)


def test_minimal_correspondences(device) -> CrashResult:
    """3-point minimum."""
    p = synthetic.minimal_cloud(3, seed=0)
    ok, _ = _finite_fit(p, p + 1.0, device)
    return CrashResult("minimal_3_correspondences", ok)


def test_collinear(device) -> CrashResult:
    """Collinear sample."""
    p = synthetic.collinear_cloud(3)
    ok, _ = _finite_fit(p, p + np.array([1.0, -2.0, 0.5]), device)
    return CrashResult("collinear_points", ok)


def test_coplanar(device) -> CrashResult:
    """Coplanar sample."""
    p = synthetic.coplanar_cloud(3, seed=1)
    ok, _ = _finite_fit(p, p * np.array([1.0, 1.0, 1.0]) + 0.3, device)
    return CrashResult("coplanar_points", ok)


def test_duplicates(device) -> CrashResult:
    """All-duplicate points."""
    p = synthetic.duplicate_cloud(3)
    ok, _ = _finite_fit(p, p, device)
    return CrashResult("duplicate_points", ok)


def test_zero_correspondences(device, sample_bits=None) -> CrashResult:
    """Empty correspondence set: a finite pose, fitness 0 (JAX: PRNGKey(0))."""
    p = np.zeros((64, 3), np.float32)
    res = _ransac(p, p, np.zeros(64, bool), device, sample_bits, 0,
                  dist_thresh=0.1, max_iterations=512, batch_size=128)
    ok = bool(np.isfinite(res.transformation.cpu().numpy()).all())
    return CrashResult("zero_correspondences", ok, f"fitness={float(res.fitness):.3f}")


NOISE_RATIOS = (0.0, 1.0, 2.0, 10.0, 100.0)


def noise_sweep_inputs() -> list[tuple[float, np.ndarray, np.ndarray]]:
    """(ratio, p, q) of each sweep step: 300 correspondences, the first
    n * ratio / (1 + ratio) of q replaced by uniform outliers."""
    rng = np.random.default_rng(0)
    n = 300
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    q_true = p + np.array([0.5, -0.3, 0.2], np.float32)
    out = []
    for ratio in NOISE_RATIOS:
        n_noise = int(n * ratio / (1 + ratio))
        q = q_true.copy()
        q[:n_noise] = rng.uniform(-2, 2, (n_noise, 3))
        out.append((ratio, p, q))
    return out


def test_noise_ratio_sweep(device, sample_bits=None) -> CrashResult:
    """Outlier-ratio sweep up to 100x (JAX: PRNGKey(1) at every ratio)."""
    fails = []
    for ratio, p, q in noise_sweep_inputs():
        res = _ransac(p, q, np.ones(len(p), bool), device, sample_bits, 1,
                      dist_thresh=0.1, max_iterations=8192, batch_size=2048)
        if not np.isfinite(res.transformation.cpu().numpy()).all():
            fails.append(ratio)
    return CrashResult("noise_ratio_sweep", not fails, f"failed ratios: {fails}")


def test_numerical_stability(device, trials: int = 1000) -> CrashResult:
    """1000 random 3-point fits: finite and orthonormal on >= 95% of them."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(trials, 3, 3)).astype(np.float32)
    q = rng.normal(size=(trials, 3, 3)).astype(np.float32)
    T = fit_rigid_horn(_tensor(p, device), _tensor(q, device)).cpu().numpy()
    finite = np.isfinite(T).all(axis=(1, 2))
    R = T[:, :3, :3]
    ortho = np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max(axis=(1, 2)) < 1e-2
    rate = float((finite & ortho).mean())
    return CrashResult("numerical_stability_1000", rate >= 0.95,
                       f"pass rate {rate:.3f} (>=0.95 good, >=0.80 moderate)")


def huge_transform_inputs() -> tuple[np.ndarray, np.ndarray]:
    """50 points at scale 1000 and their copies moved by 1000 on each axis."""
    rng = np.random.default_rng(3)
    p = (rng.normal(size=(50, 3)) * 1000).astype(np.float32)
    return p, p + 1000.0


def test_degenerate_huge_transform(device, sample_bits=None) -> CrashResult:
    """Scale-1000 + translate-1000 inputs (JAX: PRNGKey(2))."""
    p, q = huge_transform_inputs()
    res = _ransac(p, q, np.ones(50, bool), device, sample_bits, 2,
                  dist_thresh=1.0, max_iterations=1024, batch_size=256)
    ok = bool(np.isfinite(res.transformation.cpu().numpy()).all()) and float(res.fitness) > 0.9
    return CrashResult("degenerate_huge_transform", ok, f"fitness={float(res.fitness):.3f}")


ALL_TESTS = [
    test_minimal_correspondences,
    test_collinear,
    test_coplanar,
    test_duplicates,
    test_zero_correspondences,
    test_noise_ratio_sweep,
    test_numerical_stability,
    test_degenerate_huge_transform,
]


def run_all_crash_tests(device=None) -> list[CrashResult]:
    """Run every case on ``device`` (CUDA when None; raises without it)."""
    dev = resolve_device(device)
    results = []
    for fn in ALL_TESTS:
        try:
            r = fn(dev)
        except Exception as e:  # a crash IS a failure: record it and go on
            logger.exception("crash case %s raised", fn.__name__)
            r = CrashResult(fn.__name__, False, f"raised {type(e).__name__}: {e}")
        logger.info("[%s] %s %s", "PASS" if r.passed else "FAIL", r.name, r.detail)
        results.append(r)
    logger.info("crash tests: %d/%d passed", sum(r.passed for r in results), len(results))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    results = run_all_crash_tests(args.device)
    return 0 if all(r.passed for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
