"""The benchmark's own clouds, made on the device from the seed.

A frozen rewrite, in batched torch, of the arch and scan families of the
repository's synthetic benchmark pairs (``make_benchmark_pair``): the same
surfaces, scanner model and rigid motions, drawn from a ``torch.Generator``
so that a pool of hundreds of pairs takes well under a second on the card.
The random streams are this module's own: a seed gives the same clouds on
every run, not the same clouds as the program's generator.

Every function returns float32 tensors on the generator's device:
  - ``arch_pairs``: source = a dental-arch surface sample, target = the same
    points moved by a random rigid T, independent Gaussian noise on both;
  - ``scan_pairs``: source and target = two independent scanner views of
    the arch (view-dependent density, occlusion shadows, anisotropic range
    noise, flying pixels), the target moved by a random rigid T;
  - ``rigid_motions``: rotations within +-30 deg an axis about ``center``
    plus a translation within +-0.5.
"""

from __future__ import annotations

import math

import torch

ARCH_R = 5.0
SRC_VIEW = (0.0, -4.0, 9.0)
TGT_VIEW = (2.5, -6.5, 7.0)


def mix(seed: int, stream: int) -> int:
    """A 63-bit seed for sub-stream ``stream`` of ``seed`` (any whole numbers)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9) % (1 << 63)


def call_seed(seed: int, c: int) -> int:
    """A 63-bit seed for call ``c`` of a run with ``seed`` (its permutation,
    RANSAC bits and order of targets)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (c + 1) * 0x94D049BB133111EB) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for sub-stream ``stream`` of ``seed``."""
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def _uniform(shape, lo, hi, gen):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float64) * (hi - lo) + lo


def _arch_point(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The arch surface at parameters (u, v): a U-shaped half-tube with cusps."""
    tube_r = 1.2 + 0.35 * torch.sin(6.0 * u) * torch.sin(2.0 * v)
    cx = ARCH_R * torch.sin(u)
    cy = ARCH_R * (torch.cos(u) - 1.0)
    x = cx + tube_r * torch.cos(v) * torch.sin(u) * 0.4
    y = cy + tube_r * torch.cos(v) * torch.cos(u) * 0.4
    z = tube_r * torch.sin(v)
    return torch.stack([x, y, z], dim=-1)


def arch_clouds(b: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """[b, n, 3] float64 uniform samples of the arch surface's parameters."""
    u = _uniform((b, n), -0.5 * math.pi, 0.5 * math.pi, gen)
    v = _uniform((b, n), 0.0, math.pi, gen)
    return _arch_point(u, v)


def scan_clouds(b: int, n: int, view, gen: torch.Generator, *, range_noise: float = 0.004,
                lateral_noise: float = 0.001, speckle_frac: float = 0.01, n_shadows: int = 5,
                shadow_r: float = 0.7) -> torch.Tensor:
    """[b, n, 3] float64 scanner views of the arch from ``view``."""
    dev = gen.device
    m = n * 4
    u = _uniform((b, m), -0.5 * math.pi, 0.5 * math.pi, gen)
    v = _uniform((b, m), 0.0, math.pi, gen)
    p = _arch_point(u, v)
    eps = 1e-4
    pu = (_arch_point(u + eps, v) - p) / eps
    pv = (_arch_point(u, v + eps) - p) / eps
    nrm = torch.linalg.cross(pu, pv)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True), 1e-12)
    ray = torch.tensor(view, dtype=torch.float64, device=dev) - p
    rayn = ray / torch.clamp_min(torch.linalg.norm(ray, dim=-1, keepdim=True), 1e-12)
    cosang = torch.abs(torch.sum(nrm * rayn, dim=-1))
    keep = torch.rand((b, m), generator=gen, device=dev, dtype=torch.float64) \
        < torch.clamp(cosang, 0.0, 1.0) ** 0.7
    for _ in range(n_shadows):
        # One shadow centre among each cloud's points still kept.
        c_idx = torch.multinomial(keep.to(torch.float64) + 1e-30, 1, generator=gen)
        c = torch.gather(p, 1, c_idx[..., None].expand(-1, -1, 3))
        keep &= torch.sum((p - c) ** 2, dim=-1) > shadow_r ** 2
    n_speckle = int(n * speckle_frac)
    n_surf = n - n_speckle
    if int(keep.sum(dim=1).min()) < n_surf:
        raise RuntimeError("scan_clouds: a view kept fewer points than it needs")
    # n_surf kept points a cloud, chosen at random.
    score = torch.rand((b, m), generator=gen, device=dev, dtype=torch.float64)
    score = torch.where(keep, score, 2.0)
    sel = torch.argsort(score, dim=1)[:, :n_surf]
    p = torch.gather(p, 1, sel[..., None].expand(-1, -1, 3))
    rayn = torch.gather(rayn, 1, sel[..., None].expand(-1, -1, 3))
    rng = torch.randn((b, n_surf), generator=gen, device=dev, dtype=torch.float64)
    p = p + rayn * (range_noise * rng)[..., None]
    lat = lateral_noise * torch.randn((b, n_surf, 3), generator=gen, device=dev,
                                      dtype=torch.float64)
    lat = lat - rayn * torch.sum(lat * rayn, dim=-1, keepdim=True)
    p = p + lat
    if n_speckle > 0:
        js = torch.randint(0, n_surf, (b, n_speckle), generator=gen, device=dev)
        js3 = js[..., None].expand(-1, -1, 3)
        depth = _uniform((b, n_speckle), 0.2, 2.0, gen)
        fly = torch.gather(p, 1, js3) + torch.gather(rayn, 1, js3) * depth[..., None]
        p = torch.cat([p, fly], dim=1)
    return p


def _rot(a: torch.Tensor) -> torch.Tensor:
    """[b, 3, 3] rotations Rz(c) Ry(b) Rx(a) from [b, 3] angles."""
    ca, sa = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(ca[:, 0]), torch.zeros_like(ca[:, 0])
    rx = torch.stack([one, zero, zero, zero, ca[:, 0], -sa[:, 0], zero, sa[:, 0], ca[:, 0]],
                     -1).reshape(-1, 3, 3)
    ry = torch.stack([ca[:, 1], zero, sa[:, 1], zero, one, zero, -sa[:, 1], zero, ca[:, 1]],
                     -1).reshape(-1, 3, 3)
    rz = torch.stack([ca[:, 2], -sa[:, 2], zero, sa[:, 2], ca[:, 2], zero, zero, zero, one],
                     -1).reshape(-1, 3, 3)
    return rz @ ry @ rx


def rigid_motions(b: int, center: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """[b, 4, 4] float64 motions: R within +-30 deg an axis about ``center``
    ([b, 3]), then a translation within +-0.5."""
    R = _rot(_uniform((b, 3), -math.pi / 6, math.pi / 6, gen))
    t = _uniform((b, 3), -0.5, 0.5, gen)
    T = torch.zeros((b, 4, 4), dtype=torch.float64, device=gen.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = center - (R @ center[..., None])[..., 0] + t
    T[:, 3, 3] = 1.0
    return T


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[b, n, 3] points moved by [b, 4, 4] transforms."""
    return pts @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3]


def _pairs(src: torch.Tensor, tgt: torch.Tensor, sigma: float, gen: torch.Generator):
    T = rigid_motions(src.shape[0], src.mean(dim=1), gen)
    tgt = apply(T, tgt)
    if sigma > 0:
        tgt = tgt + sigma * torch.randn(tgt.shape, generator=gen, device=gen.device,
                                        dtype=torch.float64)
        src = src + sigma * torch.randn(src.shape, generator=gen, device=gen.device,
                                        dtype=torch.float64)
    return src.float(), tgt.float(), T


def arch_pairs(b: int, n: int, gen: torch.Generator, *, sigma: float = 0.0):
    """(src [b, n, 3], tgt [b, n, 3], T_true [b, 4, 4] float64), tgt ~ T_true src."""
    src = arch_clouds(b, n, gen)
    return _pairs(src, src.clone(), sigma, gen)


def scan_pairs(b: int, n: int, gen: torch.Generator, *, sigma: float = 0.0, chunk: int = 64):
    """(src [b, n, 3], tgt [b, n, 3], T_true [b, 4, 4] float64): two independent
    scans a pair, made ``chunk`` pairs at a time."""
    out = []
    for lo in range(0, b, chunk):
        k = min(chunk, b - lo)
        out.append(_pairs(scan_clouds(k, n, SRC_VIEW, gen), scan_clouds(k, n, TGT_VIEW, gen),
                          sigma, gen))
    return tuple(torch.cat(parts) for parts in zip(*out))


def make_pairs(family: str, b: int, n: int, gen: torch.Generator, *, sigma: float = 0.0):
    if family == "arch":
        return arch_pairs(b, n, gen, sigma=sigma)
    if family == "scan":
        return scan_pairs(b, n, gen, sigma=sigma)
    raise ValueError(f"unknown family {family!r}")
