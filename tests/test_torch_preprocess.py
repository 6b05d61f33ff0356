"""Port parity for tpu3dm_torch's preprocessing (CPU, small clouds).

Both packages' kNN slabs expand d2 as |a|^2 + |b|^2 - 2ab, but XLA sums
the squared norms as an FMA chain, so a neighbour set can differ where two
distances tie within fp32 rounding.  Hence two levels of test: each stage on
IDENTICAL kNN slots (tight tolerances), and ``preprocess_points`` end to end
(a tolerance for the near-ties).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops.eigh3 import smallest_eigvec_sym3 as j_eig
from tpu3dm.ops.topk import nn_topk as j_topk
from tpu3dm.core.cloud import PointCloud as JPointCloud
from tpu3dm.preprocess.fpfh import fpfh_from_knn as j_fpfh
from tpu3dm.preprocess.normals import estimate_normals as j_estimate
from tpu3dm.preprocess.normals import estimate_normals_capped as j_estimate_capped
from tpu3dm.preprocess.normals import normals_from_knn as j_normals
from tpu3dm.preprocess.normals import radius_covariance_stats as j_stats
from tpu3dm.preprocess.pipeline import preprocess_points as j_preprocess
from tpu3dm.preprocess.voxel import voxel_downsample_host as j_voxel
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.io import synthetic as psyn
from tpu3dm_torch.ops.eigh3 import smallest_eigvec_sym3 as p_eig
from tpu3dm_torch.ops.topk import nn_topk as p_topk
from tpu3dm_torch.preprocess.fpfh import fpfh_from_knn as p_fpfh
from tpu3dm_torch.preprocess import normals as p_normals_mod
from tpu3dm_torch.preprocess.normals import estimate_normals as p_estimate
from tpu3dm_torch.preprocess.normals import estimate_normals_capped as p_estimate_capped
from tpu3dm_torch.preprocess.normals import normals_from_knn as p_normals
from tpu3dm_torch.preprocess.normals import radius_covariance_stats as p_stats
from tpu3dm_torch.preprocess.pipeline import preprocess_points as p_preprocess
from tpu3dm_torch.preprocess.voxel import voxel_downsample_host as p_voxel

CFG = PipelineConfig.with_voxel_size(0.3).preprocess


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _arrays(pc):
    return {f: np.asarray(getattr(pc, f)) for f in ("points", "normals", "features", "mask")}


@pytest.fixture(scope="module")
def arch_down():
    """A 4000-point arch, voxel-downsampled and kNN-scanned by JAX."""
    pts, _, _ = make_benchmark_pair(4000, seed=2, sigma=0.01)
    down = j_voxel(pts, CFG.voxel_size)
    sent = jnp.where(jnp.asarray(down.mask)[:, None], jnp.asarray(down.points), 1e9)
    d2, idx, valid = j_topk(sent, sent, down.mask, down.mask, k=CFG.fpfh_max_nn,
                            radius=jnp.float32(CFG.fpfh_radius))
    return pts, down, (np.asarray(d2), np.asarray(idx), np.asarray(valid))


def test_synthetic_pair_matches_jax():
    sj, tj, Tj = make_benchmark_pair(3000, seed=5, sigma=0.01)
    sp, tp, Tp = psyn.make_benchmark_pair(3000, seed=5, sigma=0.01)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(tp, tj)
    np.testing.assert_array_equal(Tp, Tj)


def test_voxel_downsample_matches_jax():
    pts, _, _ = make_benchmark_pair(6000, seed=1)
    dj = j_voxel(pts, 0.3)
    dp = p_voxel(pts, 0.3, device="cpu")
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))
    np.testing.assert_allclose(dp.points.numpy(), np.asarray(dj.points), atol=1e-6)
    assert dp.capacity == dj.capacity


def test_nn_topk_ties_go_to_smaller_index():
    # Four targets at distance 1 from the query, then one at distance 2.
    t = np.array([[0, 0, 2], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]], np.float32)
    q = np.zeros((1, 3), np.float32)
    d2, idx, valid = p_topk(_t(q), _t(t), k=4)
    np.testing.assert_array_equal(idx[0].numpy(), [1, 2, 3, 4])
    np.testing.assert_allclose(d2[0].numpy(), [1, 1, 1, 1])
    d2j, idxj, _ = j_topk(jnp.asarray(q), jnp.asarray(t), k=4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idxj))
    _, idx_r, valid_r = p_topk(_t(q), _t(t), k=5, radius=1.5)
    assert valid_r[0].numpy().tolist() == [True] * 4 + [False]


def test_nn_topk_matches_jax_on_integer_grid():
    # Integer coordinates: every d2 is exact in both packages, ties abound.
    rng = np.random.default_rng(0)
    pts = rng.integers(-4, 5, size=(300, 3)).astype(np.float32)
    mask = rng.random(300) > 0.1
    d2j, idxj, vj = j_topk(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(mask), k=20, radius=2.5)
    d2p, idxp, vp = p_topk(_t(pts), _t(pts), _t(mask), _t(mask), k=20, radius=2.5)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    v = np.asarray(vj)
    np.testing.assert_array_equal(idxp.numpy()[v], np.asarray(idxj)[v])
    np.testing.assert_array_equal(d2p.numpy()[v], np.asarray(d2j)[v])


def test_smallest_eigvec_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(200, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    A[:5] = np.diag([3.0, 1.0, 2.0]).astype(np.float32)  # diagonal branch
    lj, vj = j_eig(jnp.asarray(A))
    lp, vp = p_eig(_t(A))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-5)
    dots = np.abs(np.sum(vp.numpy() * np.asarray(vj), axis=1))
    assert dots.min() > 0.9999


def test_normals_from_same_knn_match_jax(arch_down):
    """Same slots, same normals up to the eigensolver's rounding; both
    orientations point outward, so equal up to sign means equal."""
    _, down, (d2, idx, valid) = arch_down
    r2n = float(np.float32(CFG.normal_radius) ** 2)
    nv = valid[:, :30] & (d2[:, :30] <= r2n)
    nj = np.asarray(j_normals(down, jnp.asarray(idx[:, :30]), jnp.asarray(nv)).normals)
    pc = from_reference_arrays(_arrays(down), device="cpu")
    npn = p_normals(pc, _t(idx[:, :30]).long(), _t(nv)).normals.numpy()
    m = np.asarray(down.mask)
    dots = np.sum(npn * nj, axis=1)[m]
    assert dots.min() > 0.9999


def test_fpfh_from_same_knn_matches_jax(arch_down):
    """Same slots and normals: FPFH within 1e-5 relative (L1 per point)."""
    _, down, (d2, idx, valid) = arch_down
    r2n = float(np.float32(CFG.normal_radius) ** 2)
    nv = valid[:, :30] & (d2[:, :30] <= r2n)
    dn = j_normals(down, jnp.asarray(idx[:, :30]), jnp.asarray(nv))
    fj = np.asarray(j_fpfh(dn, jnp.asarray(d2), jnp.asarray(idx), jnp.asarray(valid)).features)
    pc = from_reference_arrays(_arrays(dn), device="cpu")
    fp = p_fpfh(pc, _t(d2), _t(idx).long(), _t(valid)).features.numpy()
    m = np.asarray(down.mask)
    rel = np.abs(fp - fj).sum(1)[m] / np.abs(fj).sum(1)[m]
    assert rel.max() < 1e-5
    assert np.all(fp[~m] == 0)


def test_preprocess_points_matches_jax():
    """End to end on a 4000-point arch: points exact, normals equal, FPFH
    close.  The kNN slabs differ in the last bits (XLA sums |a|^2 as an FMA
    chain), so a near-tie at the 100-neighbour cap can swap a neighbour and
    FPFH's 1/d^2 weighting spreads that to its neighbours; the first bounds
    below allow for that.  The shared scan pins each point's distance to
    itself at 0 (``nn_topk(self_pairs=True)``): computed, its rounding
    residue let some points count themselves as a neighbour with weight
    1/d^2 (relative L1 up to 0.40 and 88% of JAX's mutual correspondences
    before the pin).  Now the relative L1 difference has median 1.1e-7 and
    max 2.1e-5, and every mutual correspondence of JAX's is found again;
    the last two bounds hold that."""
    from tpu3dm.ops.nn import nn_mutual_mask

    sp, tp, _ = make_benchmark_pair(4000, seed=2, sigma=0.01)
    sj, tj = j_preprocess(sp, CFG).down, j_preprocess(tp, CFG).down
    spt, tpt = (p_preprocess(x, CFG, device="cpu").down for x in (sp, tp))
    m = np.asarray(sj.mask)
    np.testing.assert_array_equal(spt.mask.numpy(), m)
    np.testing.assert_array_equal(spt.points.numpy(), np.asarray(sj.points))
    dots = np.sum(spt.normals.numpy() * np.asarray(sj.normals), axis=1)[m]
    assert (dots > 0.9999).mean() >= 0.99 and dots.min() > 0.9
    fj, fp = np.asarray(sj.features), spt.features.numpy()
    rel = np.abs(fp - fj).sum(1)[m] / np.abs(fj).sum(1)[m]
    assert np.median(rel) < 2e-3 and np.quantile(rel, 0.9) < 1e-2 and rel.max() < 0.6
    ij, mj = (np.asarray(x) for x in nn_mutual_mask(sj.features, tj.features, sj.mask, tj.mask))
    ip, mp = (np.asarray(x) for x in nn_mutual_mask(
        jnp.asarray(fp), jnp.asarray(tpt.features.numpy()), sj.mask, tj.mask))
    assert (mj & mp & (ij == ip)).sum() >= 0.75 * mj.sum()
    assert rel.max() < 1e-3 and (mj & mp & (ij == ip)).sum() >= 0.99 * mj.sum()


# ---------------------------------------------------------------------------
# Full-resolution normals (estimate_normals / estimate_normals_capped)
# ---------------------------------------------------------------------------
#
# Both packages expand d2 as |q|^2 + |t|^2 - 2 q.t in fp32 and sum the
# moments through matmuls in their own orders, so a point on the radius can
# fall in or out, and the covariance E[p p^T] - mean mean^T cancels in
# fp32.  Tolerance: |n_port . n_jax| > 0.9999 on >= 99% of valid rows;
# a positive dot on every valid row whose normal is more than ~6 deg from
# perpendicular to the outward direction (|n_jax . u| > 0.1, u the unit
# vector from the centroid), since both orient outward; masked rows exactly
# 0.  Nearer perpendicular the outward test is decided by the last bits: on
# the far arch with the 30-neighbour cap one row's two normals, a few
# degrees apart and both within a few degrees of perpendicular to u, point
# opposite ways.
# "Far" below is a shift of ~25 units: there |p|^2 ~ 600 and the moments
# keep ~4 digits; past ~30 units the cancellation leaves so little that a
# few normals of either package flip (JAX against itself at the origin too).
FAR = np.array([20.0, -14.0, 8.0])


def _assert_normals_agree(n_port, n_jax, points, mask):
    dots = np.sum(n_port * n_jax, axis=1)
    assert (np.abs(dots[mask]) > 0.9999).mean() >= 0.99
    u = points - points[mask].mean(0)
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
    decided = mask & (np.abs(np.sum(n_jax * u, axis=1)) > 0.1)
    assert decided.mean() >= 0.9 * mask.mean()
    assert dots[decided].min() > 0.0
    assert np.all(n_port[~mask] == 0) and np.all(n_jax[~mask] == 0)


def _padded_arch(n, seed, masked_every=17):
    """An n-point arch in a capacity of n + 200 rows, every masked_every-th
    row masked as well as the padding."""
    sp, _, _ = make_benchmark_pair(n, seed=seed, sigma=0.01)
    pts = np.zeros((n + 200, 3), np.float32)
    pts[:n] = sp
    mask = np.zeros(n + 200, bool)
    mask[:n] = True
    mask[::masked_every] = False
    return pts, mask


@pytest.mark.parametrize("n", [4000, 9000])  # 9000: two query blocks of 8192
def test_radius_covariance_stats_match_jax(n):
    """Counts equal on >= 99.9% of valid rows and never more than 1 apart (a
    neighbour on the radius); where equal, sum and sumsq within 1e-5 of the
    row's scale (count x max |p|, count x max |p|^2); masked rows' stats
    are those of JAX too (both count a masked query's sentinel row as no
    neighbour of anything)."""
    pts, mask = _padded_arch(n, seed=3)
    r = CFG.normal_radius
    cj, sj, ssj = (np.asarray(x) for x in j_stats(jnp.asarray(pts), jnp.asarray(mask), r))
    cp, sp, ssp = (x.numpy() for x in p_stats(_t(pts), _t(mask), r))
    assert (cp[mask] == cj[mask]).mean() >= 0.999
    assert np.abs(cp - cj).max() <= 1.0
    eq = mask & (cp == cj)
    pmax = np.abs(pts[mask]).max()
    assert np.all(np.abs(sp - sj)[eq] <= 1e-5 * cj[eq, None] * pmax)
    assert np.all(np.abs(ssp - ssj)[eq] <= 1e-5 * cj[eq, None] * pmax ** 2)
    assert np.all(cp[~mask] == cj[~mask])


def test_radius_covariance_stats_query_blocks_change_nothing(monkeypatch):
    """Query blocks of 8192 or of 1000 rows: the same moments bit for bit
    (each query row's sums run over the same target blocks in order)."""
    pts, mask = _padded_arch(3000, seed=4)
    one = p_stats(_t(pts), _t(mask), CFG.normal_radius)
    monkeypatch.setattr(p_normals_mod, "QUERY_CHUNK", 1000)
    many = p_stats(_t(pts), _t(mask), CFG.normal_radius)
    assert all(torch.equal(a, b) for a, b in zip(one, many))


def _clouds(pts, mask):
    """The same padded cloud in both packages (strided mask included)."""
    arrays = {"points": pts, "mask": mask, "normals": np.zeros_like(pts),
              "features": np.zeros((len(mask), 0), np.float32)}
    jc = JPointCloud(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jc, from_reference_arrays(arrays, device="cpu")


@pytest.mark.parametrize("n", [4000, 9000])  # 9000: two query blocks of 8192
def test_estimate_normals_match_jax(n):
    pts, mask = _padded_arch(n, seed=5)
    jc, pc = _clouds(pts, mask)
    nj = np.asarray(j_estimate(jc, CFG.normal_radius).normals)
    npn = p_estimate(pc, CFG.normal_radius).normals.numpy()
    _assert_normals_agree(npn, nj, pts, mask)
    assert np.abs(np.linalg.norm(npn[mask], axis=1) - 1).max() < 1e-5


@pytest.mark.parametrize("max_nn", [10, 30])
def test_estimate_normals_capped_matches_jax(max_nn):
    pts, mask = _padded_arch(4000, seed=6)
    jc, pc = _clouds(pts, mask)
    nj = np.asarray(j_estimate_capped(jc, CFG.normal_radius, max_nn=max_nn).normals)
    npn = p_estimate_capped(pc, CFG.normal_radius, max_nn=max_nn).normals.numpy()
    _assert_normals_agree(npn, nj, pts, mask)


@pytest.mark.parametrize("shift", ["origin", "far"])
@pytest.mark.parametrize("full_max_nn", [0, 30])
def test_preprocess_points_full_normals_match_jax(full_max_nn, shift):
    """``full`` carries normals wherever JAX's does: all radius neighbours
    (full_normal_max_nn = 0, the default) or the nearest 30, on a
    4000-point arch at the origin and ~25 units away; ``down`` is untouched
    by the choice."""
    cfg = dataclasses.replace(CFG, full_normal_max_nn=full_max_nn)
    sp, _, _ = make_benchmark_pair(4000, seed=2, sigma=0.01)
    if shift == "far":
        sp = sp + FAR
    fj = j_preprocess(sp, cfg).full
    out = p_preprocess(sp, cfg, device="cpu")
    m = np.asarray(fj.mask)
    np.testing.assert_array_equal(out.full.mask.numpy(), m)
    np.testing.assert_array_equal(out.full.points.numpy(), np.asarray(fj.points))
    _assert_normals_agree(out.full.normals.numpy(), np.asarray(fj.normals),
                          np.asarray(fj.points), m)
    assert np.abs(np.linalg.norm(out.full.normals.numpy()[m], axis=1) - 1).max() < 1e-5


# ---------------------------------------------------------------------------
# The unshared and uncapped feature routes (compute_fpfh, compute_fpfh_capped,
# down_features without the shared scan)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def arch_normals():
    """arch_down's cloud with JAX's capped normals, in both packages."""
    from tpu3dm.preprocess.normals import estimate_normals_capped as j_capped

    pts, _, _ = make_benchmark_pair(4000, seed=2, sigma=0.01)
    dn = j_capped(j_voxel(pts, CFG.voxel_size), CFG.normal_radius, max_nn=CFG.normal_max_nn)
    return dn, from_reference_arrays(_arrays(dn), device="cpu")


def _rel_l1(fp, fj, m):
    return np.abs(fp - fj).sum(1)[m] / np.abs(fj).sum(1)[m]


def test_spfh_block_matches_jax(arch_normals):
    """One 512-row target block against every query: the same histogram and
    neighbour counts exactly, the 1 / |d| weights within 1e-6 of their
    largest."""
    from tpu3dm.preprocess.fpfh import _spfh_block as j_spfh
    from tpu3dm_torch.preprocess.fpfh import _spfh_block as p_spfh

    dn, pc = arch_normals
    r2 = np.float32(CFG.fpfh_radius) ** 2
    pj = jnp.where(dn.mask[:, None], dn.points, 1e9)
    hj, cj, wj = (np.asarray(x) for x in j_spfh(pj, dn.normals, pj[:512], dn.normals[:512],
                                                 dn.mask[:512], jnp.float32(r2)))
    pp = torch.where(pc.mask[:, None], pc.points, 1e9)
    hp, cp, wp = (x.numpy() for x in p_spfh(pp, pc.normals, pp[:512], pc.normals[:512],
                                             pc.mask[:512], float(r2)))
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(cp, cj)
    assert np.abs(wp - wj).max() <= 1e-6 * np.abs(wj).max()


@pytest.mark.parametrize("capped", [False, True])
def test_compute_fpfh_matches_jax(arch_normals, capped):
    """Same cloud and normals: the all-neighbour FPFH within 1e-5 relative
    L1 a point (1.3e-7 seen), the capped one within 1e-4 (2.1e-5 seen: its
    kNN scan's near-ties, as the shared route's); masked rows 0.  A batch
    of two clouds gives each cloud's features bit for bit."""
    from tpu3dm.preprocess.fpfh import compute_fpfh as j_fpfh_all
    from tpu3dm.preprocess.fpfh import compute_fpfh_capped as j_fpfh_capped
    from tpu3dm_torch.preprocess.fpfh import compute_fpfh, compute_fpfh_capped

    dn, pc = arch_normals
    if capped:
        fj = j_fpfh_capped(dn, CFG.fpfh_radius, max_nn=CFG.fpfh_max_nn).features
        fn = lambda c: compute_fpfh_capped(c, CFG.fpfh_radius, max_nn=CFG.fpfh_max_nn)  # noqa: E731
    else:
        fj = j_fpfh_all(dn, CFG.fpfh_radius).features
        fn = lambda c: compute_fpfh(c, CFG.fpfh_radius)  # noqa: E731
    fp = fn(pc).features.numpy()
    m = np.asarray(dn.mask)
    assert _rel_l1(fp, np.asarray(fj), m).max() < (1e-4 if capped else 1e-5)
    assert np.all(fp[~m] == 0)
    other = pc.with_(points=pc.points.flip(0), mask=pc.mask.flip(0), normals=pc.normals.flip(0))
    pair = fn(type(pc)(*(torch.stack([getattr(pc, f), getattr(other, f)])
                         for f in ("points", "mask", "normals", "features"))))
    assert torch.equal(pair.features[0], torch.from_numpy(fp))
    assert torch.equal(pair.features[1], fn(other).features)


UNSHARED = {
    "uncapped": dict(normal_max_nn=0, fpfh_max_nn=0),
    "fpfh_uncapped": dict(fpfh_max_nn=0),
    "normals_uncapped": dict(normal_max_nn=0),
    "normal_radius_over_fpfh": dict(normal_radius_mult=6.0),
}


@pytest.mark.parametrize("route", sorted(UNSHARED))
def test_unshared_down_features_match_jax(route):
    """``preprocess_points_batch`` on configurations JAX runs without the
    shared scan: a cap of 0 (every neighbour in the radius) or a normal
    radius above the FPFH radius.  The down points exactly, the normals
    within the full-resolution normals' bounds above (the all-neighbour
    moments differ in the last bits), and the features within the end-to-end
    bounds of test_preprocess_points_matches_jax, relative L1 a point:
    median < 1e-3, 90% < 5e-3, max < 0.05 (4e-5, 2.3e-4 and 6.6e-3 seen:
    a normal a few ulps off moves a neighbour's angle across a bin edge)."""
    from tpu3dm.preprocess.pipeline import preprocess_points_batch as j_batch
    from tpu3dm_torch.core.config import PipelineConfig as PConfig
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch as p_batch

    cfg = dataclasses.replace(CFG, **UNSHARED[route])
    pcfg = dataclasses.replace(PConfig.with_voxel_size(0.3).preprocess, **UNSHARED[route])
    clouds = [make_benchmark_pair(n, seed=s, sigma=0.01)[0] for s, n in ((1, 4000), (4, 3000))]
    jout = j_batch(clouds, cfg, full_normals=False)
    pout = p_batch(clouds, pcfg, full_normals=False, device="cpu")
    for j, p in zip(jout, pout):
        m = np.asarray(j.down.mask)
        np.testing.assert_array_equal(p.down.mask.numpy(), m)
        np.testing.assert_array_equal(p.down.points.numpy(), np.asarray(j.down.points))
        _assert_normals_agree(p.down.normals.numpy(), np.asarray(j.down.normals),
                              np.asarray(j.down.points), m)
        rel = _rel_l1(p.down.features.numpy(), np.asarray(j.down.features), m)
        assert np.median(rel) < 1e-3 and np.quantile(rel, 0.9) < 5e-3 and rel.max() < 0.05
        assert np.all(p.down.features.numpy()[~m] == 0)


def test_down_features_without_share_knn_matches_jax(arch_down):
    """Default caps with ``share_knn=False``: capped normals, then the
    capped FPFH from its own scan, as JAX's unshared branch; relative L1
    within 1e-4 a point (2.1e-5 seen)."""
    from tpu3dm.preprocess.pipeline import down_features as j_down_features
    from tpu3dm_torch.preprocess.pipeline import down_features as p_down_features

    _, down, _ = arch_down
    kw = dict(normal_max_nn=CFG.normal_max_nn, fpfh_max_nn=CFG.fpfh_max_nn, share_knn=False)
    j = j_down_features(down, CFG.normal_radius, CFG.fpfh_radius, **kw)
    p = p_down_features(from_reference_arrays(_arrays(down), device="cpu"), CFG.normal_radius,
                        CFG.fpfh_radius, **kw)
    m = np.asarray(down.mask)
    assert np.sum(p.normals.numpy() * np.asarray(j.normals), axis=1)[m].min() > 0.9999
    assert _rel_l1(p.features.numpy(), np.asarray(j.features), m).max() < 1e-4
