"""Port parity for tpu3dm_torch's preprocessing (CPU, small clouds).

Both packages' kNN slabs expand d2 as |a|^2 + |b|^2 - 2ab, but XLA sums
the squared norms as an FMA chain, so a neighbour set can differ where two
distances tie within fp32 rounding.  Hence two levels of test: each stage on
IDENTICAL kNN slots (tight tolerances), and ``preprocess_points`` end to end
(a tolerance for the near-ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops.eigh3 import smallest_eigvec_sym3 as j_eig
from tpu3dm.ops.topk import nn_topk as j_topk
from tpu3dm.preprocess.fpfh import fpfh_from_knn as j_fpfh
from tpu3dm.preprocess.normals import normals_from_knn as j_normals
from tpu3dm.preprocess.pipeline import preprocess_points as j_preprocess
from tpu3dm.preprocess.voxel import voxel_downsample_host as j_voxel
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.io import synthetic as psyn
from tpu3dm_torch.ops.eigh3 import smallest_eigvec_sym3 as p_eig
from tpu3dm_torch.ops.topk import nn_topk as p_topk
from tpu3dm_torch.preprocess.fpfh import fpfh_from_knn as p_fpfh
from tpu3dm_torch.preprocess.normals import normals_from_knn as p_normals
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
    chain), so near-ties at the 100-neighbour cap swap a neighbour of some
    points and FPFH's 1/d^2 weighting spreads that to their neighbours.  On
    this arch the relative L1 difference has median 4.4e-4, 90th percentile
    2.8e-3 and max 0.40, and 88% of JAX's mutual FPFH correspondences are
    found again; the bounds below sit above those."""
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
