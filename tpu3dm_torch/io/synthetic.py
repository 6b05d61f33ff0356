"""Synthetic clouds: a NumPy copy of tpu3dm/io/synthetic.py (the
degenerate-geometry fixtures of the crash suite, and the arch, plate and
scan benchmark families).

The same seeds give the same arrays as the JAX package's generators, so both
packages can register the same pairs.
"""

from __future__ import annotations

import numpy as np


def minimal_cloud(n: int = 3, seed: int = 0) -> np.ndarray:
    """N random points (the reference crash suite's minimal-N cloud)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=(n, 3))


def collinear_cloud(n: int = 10, seed: int = 0) -> np.ndarray:
    """Points on a line."""
    t = np.linspace(0.0, 1.0, n)[:, None]
    return t * np.array([[1.0, 2.0, 3.0]])


def coplanar_cloud(n: int = 16, seed: int = 0) -> np.ndarray:
    """Points on a plane."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.0, 1.0, size=(n, 2))
    e1 = np.array([1.0, 0.0, 0.5])
    e2 = np.array([0.0, 1.0, -0.25])
    return uv[:, :1] * e1 + uv[:, 1:] * e2


def duplicate_cloud(n: int = 10) -> np.ndarray:
    """All-identical points."""
    return np.tile(np.array([[0.5, -0.25, 1.0]]), (n, 1))


def random_cloud(n: int = 1000, scale: float = 1.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, size=(n, 3))


def sphere_cloud(n: int = 2000, radius: float = 1.0, seed: int = 0) -> np.ndarray:
    """Uniform points on a sphere surface: simple geometry with known normals."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return radius * v


def dental_arch_cloud(
    n: int = 20_000,
    *,
    seed: int = 0,
    noise: float = 0.0,
) -> np.ndarray:
    """Dental-arch-like surface: a U-shaped half-tube with cusp bumps, a few
    units across, so voxel_size=0.3 downsamples ~20k points to under a
    thousand."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5 * np.pi, 0.5 * np.pi, size=n)
    v = rng.uniform(0.0, np.pi, size=n)
    arch_r = 5.0
    tube_r = 1.2 + 0.35 * np.sin(6.0 * u) * np.sin(2.0 * v)  # cusps
    cx = arch_r * np.sin(u)
    cy = arch_r * (np.cos(u) - 1.0)
    x = cx + tube_r * np.cos(v) * np.sin(u) * 0.4
    y = cy + tube_r * np.cos(v) * np.cos(u) * 0.4
    z = tube_r * np.sin(v)
    pts = np.stack([x, y, z], axis=1)
    if noise > 0:
        pts += noise * rng.standard_normal(pts.shape)
    return pts


def plate_with_holes_cloud(
    n: int = 20_000,
    *,
    seed: int = 0,
    noise: float = 0.0,
) -> np.ndarray:
    """CAD-like industrial part: a plate with drilled holes and a boss.

    Second benchmark geometry family (distinct from the dental arch): large
    planar regions with sharp cylindrical features — the FPFH/rescue
    regime of machined parts rather than organic surfaces.  Plate 6 x 4
    units, thickness 0.4; three holes of different radii placed
    asymmetrically; one raised cylindrical boss.  Same overall scale as
    the arch so voxel_size=0.3 produces comparable downsampled sizes.

    Used to validate the alias-rescue election margins
    (registration/fused.py RESCUE_TIE_RATIO / RESCUE_OVERRIDE_MARGIN) on a
    shape class they were not calibrated on.
    """
    rng = np.random.default_rng(seed)
    lx, ly, th = 6.0, 4.0, 0.4
    holes = [(1.5, 1.2, 0.6), (4.5, 2.8, 0.9), (3.0, 1.0, 0.35)]
    boss = (2.2, 2.9, 0.7, 0.5)  # cx, cy, r, height

    def in_hole(x, y):
        keep = np.zeros_like(x, bool)
        for cx, cy, r in holes:
            keep |= (x - cx) ** 2 + (y - cy) ** 2 < r**2
        return keep

    parts = []
    # Top + bottom faces (~60% of points), holes rejected.
    n_face = int(n * 0.6)
    x = rng.uniform(0, lx, n_face * 2)
    y = rng.uniform(0, ly, n_face * 2)
    ok = ~in_hole(x, y)
    x, y = x[ok][:n_face], y[ok][:n_face]
    z = np.where(rng.random(x.shape[0]) < 0.5, 0.0, th)
    parts.append(np.stack([x, y, z], axis=1))
    # Hole walls (~15%).
    n_walls = int(n * 0.15)
    per = max(1, n_walls // len(holes))
    for cx, cy, r in holes:
        a = rng.uniform(0, 2 * np.pi, per)
        hz = rng.uniform(0, th, per)
        parts.append(np.stack([cx + r * np.cos(a), cy + r * np.sin(a), hz], axis=1))
    # Outer side walls (~10%).
    n_side = int(n * 0.10)
    t = rng.uniform(0, 2 * (lx + ly), n_side)
    sz = rng.uniform(0, th, n_side)
    sx = np.empty(n_side)
    sy = np.empty(n_side)
    m0 = t < lx
    m1 = (t >= lx) & (t < lx + ly)
    m2 = (t >= lx + ly) & (t < 2 * lx + ly)
    m3 = t >= 2 * lx + ly
    sx[m0], sy[m0] = t[m0], 0.0
    sx[m1], sy[m1] = lx, t[m1] - lx
    sx[m2], sy[m2] = 2 * lx + ly - t[m2], ly
    sx[m3], sy[m3] = 0.0, 2 * (lx + ly) - t[m3]
    parts.append(np.stack([sx, sy, sz], axis=1))
    # Boss: cylinder wall + cap (~15%).
    n_boss = n - sum(p.shape[0] for p in parts)
    cx, cy, r, h = boss
    n_wall = n_boss // 2
    a = rng.uniform(0, 2 * np.pi, n_wall)
    bz = rng.uniform(th, th + h, n_wall)
    parts.append(np.stack([cx + r * np.cos(a), cy + r * np.sin(a), bz], axis=1))
    n_cap = n_boss - n_wall
    rr = r * np.sqrt(rng.random(n_cap))
    a = rng.uniform(0, 2 * np.pi, n_cap)
    parts.append(
        np.stack([cx + rr * np.cos(a), cy + rr * np.sin(a),
                  np.full(n_cap, th + h)], axis=1)
    )
    pts = np.concatenate(parts)[:n]
    # Center so random transforms rotate about the part, like the arch.
    pts = pts - pts.mean(axis=0)
    if noise > 0:
        pts += noise * rng.standard_normal(pts.shape)
    return pts


def _arch_point(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Closed-form dental-arch surface point for parameters (u, v) — the
    same parametrization as ``dental_arch_cloud``, exposed so the scanner
    model can differentiate it numerically for surface normals."""
    arch_r = 5.0
    tube_r = 1.2 + 0.35 * np.sin(6.0 * u) * np.sin(2.0 * v)
    cx = arch_r * np.sin(u)
    cy = arch_r * (np.cos(u) - 1.0)
    x = cx + tube_r * np.cos(v) * np.sin(u) * 0.4
    y = cy + tube_r * np.cos(v) * np.cos(u) * 0.4
    z = tube_r * np.sin(v)
    return np.stack([x, y, z], axis=1)


def scanned_arch_cloud(
    n: int = 20_000,
    *,
    seed: int = 0,
    view: tuple = (0.0, -4.0, 9.0),
    range_noise: float = 0.004,
    lateral_noise: float = 0.001,
    speckle_frac: float = 0.01,
    n_shadows: int = 5,
    shadow_r: float = 0.7,
) -> np.ndarray:
    """Third benchmark family: the arch as a REAL SCANNER would see it.

    The arch and plate families are clean uniform surface samples; real
    structured-light/intraoral scans (the reference's dataset shape,
    convert_stl-ply.py:3 — git-ignored, unavailable) differ in four ways,
    all modeled here:

      - **view-dependent density**: sampling probability falls with the
        grazing angle between the surface normal (numeric derivative of
        the closed-form surface) and the ray to the scanner at ``view`` —
        surfaces facing the scanner are dense, grazing ones sparse;
      - **occlusion shadows**: ``n_shadows`` random surface patches of
        radius ``shadow_r`` are dropped entirely (self-occlusion /
        line-of-sight shadowing);
      - **anisotropic range noise**: noise is ``range_noise`` ALONG the
        viewing ray (depth uncertainty) but only ``lateral_noise`` across
        it — unlike the isotropic ``sigma`` of the clean families;
      - **flying-pixel speckle**: ``speckle_frac`` of points land off the
        surface along their ray (depth outliers at silhouette edges).

    Two calls with different seeds/views sample DIFFERENT points of the
    same underlying surface — so a scan pair is a genuine two-scan
    registration problem, not a permuted copy.
    """
    rng = np.random.default_rng(seed)
    view_p = np.asarray(view, np.float64)
    m = n * 4
    u = rng.uniform(-0.5 * np.pi, 0.5 * np.pi, size=m)
    v = rng.uniform(0.0, np.pi, size=m)
    p = _arch_point(u, v)
    eps = 1e-4
    pu = (_arch_point(u + eps, v) - p) / eps
    pv = (_arch_point(u, v + eps) - p) / eps
    nrm = np.cross(pu, pv)
    nlen = np.linalg.norm(nrm, axis=1)
    nrm = nrm / np.maximum(nlen, 1e-12)[:, None]
    ray = view_p[None, :] - p
    rlen = np.linalg.norm(ray, axis=1)
    rayn = ray / np.maximum(rlen, 1e-12)[:, None]
    # Parametric normals have ambiguous orientation; |cos| keeps the
    # grazing-angle falloff (the density effect) either way.
    cosang = np.abs(np.sum(nrm * rayn, axis=1))
    keep = rng.random(m) < np.clip(cosang, 0.0, 1.0) ** 0.7
    p, rayn = p[keep], rayn[keep]
    # Occlusion shadows: drop whole patches.
    for _ in range(n_shadows):
        c = p[rng.integers(0, p.shape[0])]
        far = np.sum((p - c) ** 2, axis=1) > shadow_r**2
        p, rayn = p[far], rayn[far]
    n_speckle = int(n * speckle_frac)
    n_surf = min(n - n_speckle, p.shape[0])
    sel = rng.permutation(p.shape[0])[:n_surf]
    p, rayn = p[sel], rayn[sel]
    # Anisotropic sensor noise: range along the ray, lateral across it.
    p = p + rayn * (range_noise * rng.standard_normal(n_surf))[:, None]
    lat = lateral_noise * rng.standard_normal((n_surf, 3))
    lat -= rayn * np.sum(lat * rayn, axis=1)[:, None]
    p = p + lat
    # Flying pixels: depth outliers along rays of random surface points.
    if n_speckle > 0:
        js = rng.integers(0, n_surf, n_speckle)
        fly = p[js] + rayn[js] * rng.uniform(0.2, 2.0, n_speckle)[:, None]
        p = np.concatenate([p, fly])
    return p


def crop_fraction(points: np.ndarray, fraction: float, axis: int = 0) -> np.ndarray:
    """Keep the lower ``fraction`` of points along ``axis`` (partial overlap)."""
    lo = points[:, axis].min()
    hi = points[:, axis].max()
    keep = points[:, axis] <= lo + fraction * (hi - lo)
    return points[keep]


def make_benchmark_pair(
    n: int = 20_000,
    *,
    seed: int = 0,
    overlap: float = 1.0,
    sigma: float = 0.0,
    family: str = "arch",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source_points, target_points, true_T) benchmark fixture.

    Source = arch cloud (``family="arch"``), CAD plate (``"plate"``,
    ``plate_with_holes_cloud``) or a scan of the arch (``"scan"``): the
    target is then a second, independent scan from another scanner pose
    (``scanned_arch_cloud``), else a copy of the source.  The target is
    (optionally cropped and) moved by a random rigid T (±30 deg per axis,
    ±0.5 translation), with optional Gaussian sensor noise ``sigma`` on
    both.  Registration should recover ``true_T`` (target <- source).
    """
    rng = np.random.default_rng(seed)
    if family == "arch":
        src = dental_arch_cloud(n, seed=seed)
        tgt = src.copy()
    elif family == "plate":
        src = plate_with_holes_cloud(n, seed=seed)
        tgt = src.copy()
    elif family == "scan":
        src = scanned_arch_cloud(n, seed=seed, view=(0.0, -4.0, 9.0))
        tgt = scanned_arch_cloud(n, seed=seed + 1000, view=(2.5, -6.5, 7.0))
    else:
        raise ValueError(f"unknown benchmark family: {family!r}")
    if overlap < 1.0:
        tgt = crop_fraction(tgt, overlap, axis=0)
    angles = rng.uniform(-np.pi / 6, np.pi / 6, size=3)

    def rot(a, b, c):
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        return rz @ ry @ rx

    R = rot(*angles)
    t = rng.uniform(-0.5, 0.5, size=3)
    center = src.mean(axis=0)
    offset = -R @ center + center + t
    tgt = tgt @ R.T + offset
    if sigma > 0:
        tgt = tgt + sigma * rng.standard_normal(tgt.shape)
        src = src + sigma * rng.standard_normal(src.shape)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = offset
    return src, tgt, T
