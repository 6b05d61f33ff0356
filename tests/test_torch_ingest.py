"""Port parity for tpu3dm_torch's ingest pieces (CPU, small clouds): the
device voxel grid and ``compact``, ``voxel_downsample_many``,
``preprocess_points_batch``, noise injection (``noise_sigma`` in
preprocessing, ``noise_ratio`` in the correspondences) and the dense
features of ``preprocess/dense.py``.

Random draws cannot be shared as keys, so each test rebuilds JAX's draws
from JAX's keys and hands them to the port.  Feature tolerances are those of
``tests/test_torch_preprocess.py:test_preprocess_points_matches_jax``: the
kNN slabs of the two packages differ in the last bits (XLA sums |a|^2 as an
FMA chain), so a near-tie at the 100-neighbour cap can swap a neighbour.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.cloud import from_numpy as j_from_numpy
from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.loader import voxel_downsample_many as j_voxel_many
from tpu3dm.io.synthetic import dental_arch_cloud, make_benchmark_pair
from tpu3dm.preprocess import dense as jdense
from tpu3dm.preprocess import pipeline as jpipe
from tpu3dm.preprocess import voxel as jvoxel
from tpu3dm.registration import correspondence as jcorr
from tpu3dm.registration import ransac as jransac
from tpu3dm_torch.core.cloud import from_numpy, from_reference_arrays
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.io.loader import voxel_downsample_many
from tpu3dm_torch.ops.topk import nn_topk
from tpu3dm_torch.preprocess import dense as pdense
from tpu3dm_torch.preprocess import pipeline as ppipe
from tpu3dm_torch.preprocess import voxel as pvoxel
from tpu3dm_torch.preprocess.fpfh import fpfh_from_knn
from tpu3dm_torch.preprocess.normals import normals_from_knn
from tpu3dm_torch.registration import correspondence as pcorr
from tpu3dm_torch.registration import ransac as pransac

CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
FAR = np.array([2000.0, -2000.0, 2000.0], np.float32)  # the feature stage's far origin


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


def _assert_features_agree(port_pc, jax_pc):
    """Down normals and FPFH within the bounds of
    test_torch_preprocess.py:test_preprocess_points_matches_jax: |dot| >
    0.9999 on >= 99% of valid rows and > 0.9 on all; FPFH relative L1
    median < 2e-3, 90th percentile < 1e-2, max < 0.6; masked rows 0."""
    m = np.asarray(jax_pc.mask)
    np.testing.assert_array_equal(port_pc.mask.cpu().numpy(), m)
    np.testing.assert_array_equal(port_pc.points.cpu().numpy(), np.asarray(jax_pc.points))
    dots = np.sum(port_pc.normals.cpu().numpy() * np.asarray(jax_pc.normals), axis=1)[m]
    assert (dots > 0.9999).mean() >= 0.99 and dots.min() > 0.9
    fj, fp = np.asarray(jax_pc.features), port_pc.features.cpu().numpy()
    rel = np.abs(fp - fj).sum(1)[m] / np.abs(fj).sum(1)[m]
    assert np.median(rel) < 2e-3 and np.quantile(rel, 0.9) < 1e-2 and rel.max() < 0.6
    assert not fp[~m].any() and not port_pc.normals.cpu().numpy()[~m].any()


# ---------------------------------------------------------------------------
# The voxel grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", ["origin", "far"])
def test_voxel_downsample_device_matches_host_and_jax(shift):
    """The device grid (float64 coordinates and sums, as the host grid)
    equals the host grid exactly, capacity kept, padding masked; JAX's
    device grid (float32) has the same voxels and means within 1e-5
    relative."""
    sp, _, _ = make_benchmark_pair(5000, seed=4, sigma=0.01)
    if shift == "far":
        sp = sp + FAR
    sp = sp.astype(np.float32)  # the cloud's own values, on both routes
    pc = from_numpy(sp, device="cpu")
    out = pvoxel.voxel_downsample(pc, 0.3)
    host = pvoxel.voxel_downsample_host(sp, 0.3, device="cpu")
    n = int(host.mask.sum())
    assert out.capacity == pc.capacity and int(out.mask.sum()) == n
    assert out.mask[:n].all() and not out.points[n:].any()
    torch.testing.assert_close(out.points[:n], host.points[:n], rtol=0, atol=0)
    jo = jvoxel.voxel_downsample(j_from_numpy(sp), 0.3)
    jm = np.asarray(jo.mask)
    np.testing.assert_array_equal(out.mask.numpy(), jm)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(jo.points), rtol=1e-5, atol=1e-6)


def test_compact_matches_jax():
    """compact re-buckets the valid rows to bucket_size(n), as JAX's does."""
    sp = make_benchmark_pair(4000, seed=5, sigma=0.01)[0].astype(np.float32)
    down = pvoxel.voxel_downsample(from_numpy(sp, device="cpu"), 0.3)
    c = pvoxel.compact(down)
    jc = jvoxel.compact(jvoxel.voxel_downsample(j_from_numpy(sp), 0.3))
    assert c.capacity == jc.points.shape[0] < down.capacity
    np.testing.assert_array_equal(c.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_allclose(c.points.numpy(), np.asarray(jc.points), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c.points, pvoxel.voxel_downsample_host(sp, 0.3, device="cpu").points,
                               rtol=0, atol=0)


def test_voxel_downsample_many_matches_serial_and_jax():
    clouds = [make_benchmark_pair(3000, seed=s, sigma=0.005)[s % 2] for s in range(4)]
    threaded = voxel_downsample_many(clouds, 0.3, workers=4, device="cpu")
    serial = voxel_downsample_many(clouds, 0.3, workers=1, device="cpu")
    for c, a, b, j in zip(clouds, threaded, serial, j_voxel_many(clouds, 0.3, workers=2)):
        torch.testing.assert_close(a.points, b.points, rtol=0, atol=0)
        torch.testing.assert_close(a.points, pvoxel.voxel_downsample_host(c, 0.3, device="cpu")
                                   .points, rtol=0, atol=0)
        np.testing.assert_array_equal(a.points.numpy(), np.asarray(j.points))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(j.mask))
    assert voxel_downsample_many([], 0.3, device="cpu") == []


# ---------------------------------------------------------------------------
# preprocess_points_batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_clouds():
    sp, tp, _ = make_benchmark_pair(4000, seed=2, sigma=0.01)
    return [sp, make_benchmark_pair(3000, seed=6, sigma=0.01)[1]]


def _assert_normals_agree(n_port, n_jax, points, mask):
    """test_torch_preprocess.py's full-normal bounds: |dot| > 0.9999 on >=
    99% of valid rows, a positive dot where the outward test is decided."""
    dots = np.sum(n_port * n_jax, axis=1)
    assert (np.abs(dots[mask]) > 0.9999).mean() >= 0.99
    u = points - points[mask].mean(0)
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
    decided = mask & (np.abs(np.sum(n_jax * u, axis=1)) > 0.1)
    assert dots[decided].min() > 0.0
    assert not n_port[~mask].any()


@pytest.mark.parametrize("full_normals", [False, True])
def test_preprocess_points_batch_matches_jax(two_clouds, full_normals):
    """Shared capacities (round_up 256 of the largest cloud), down features
    within the per-cloud bounds; ``full`` at cap_f, with JAX's normals or
    host-resident with zero normals."""
    jb = jpipe.preprocess_points_batch(two_clouds, CFG.preprocess, full_normals=full_normals)
    pb = ppipe.preprocess_points_batch(two_clouds, PCFG.preprocess, full_normals=full_normals,
                                       device="cpu")
    for raw, j, p in zip(two_clouds, jb, pb):
        assert p.down.capacity == j.down.points.shape[0]
        _assert_features_agree(p.down, j.down)
        assert p.full.capacity == j.full.points.shape[0] == 4096
        assert p.full.points.device.type == "cpu"
        np.testing.assert_array_equal(p.full.points.numpy(), np.asarray(j.full.points))
        m = p.full.mask.numpy()
        if full_normals:
            _assert_normals_agree(p.full.normals.numpy(), np.asarray(j.full.normals),
                                  p.full.points.numpy(), m)
        else:
            assert not p.full.normals.any() and not np.asarray(j.full.normals).any()


def test_preprocess_points_batch_down_cap(two_clouds):
    """down_cap pins the down capacity (raised when a cloud needs more)."""
    for cap, want in ((1536, 1536), (256, 768)):
        pb = ppipe.preprocess_points_batch(two_clouds, PCFG.preprocess, full_normals=False,
                                           down_cap=cap, device="cpu")
        jb = jpipe.preprocess_points_batch(two_clouds, CFG.preprocess, full_normals=False,
                                           down_cap=cap)
        assert [p.down.capacity for p in pb] == [j.down.points.shape[0] for j in jb] == [want] * 2


def test_preprocess_points_batch_equals_per_cloud(two_clouds):
    """Each cloud's down normals and features are those of per-cloud
    preprocess_points at the same capacity, bit for bit, in whatever chunks
    the memory rule cuts."""
    pb = ppipe.preprocess_points_batch(two_clouds, PCFG.preprocess, full_normals=False,
                                       device="cpu")
    for raw, b in zip(two_clouds, pb):
        single = ppipe.preprocess_points(raw, PCFG.preprocess, device="cpu")
        assert single.down.capacity == b.down.capacity
        for f in ("points", "mask", "normals", "features"):
            torch.testing.assert_close(getattr(b.down, f), getattr(single.down, f), rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["points", "batch"])
def test_feature_stage_far_origin_matches_jax(entry):
    """ROADMAP 3.2: an arch ~2000 units from the origin, from raw points,
    through the multiple-of-64 shift of the feature stage: down normals and
    FPFH within the per-cloud bounds of JAX's."""
    sp, _, _ = make_benchmark_pair(4000, seed=2, sigma=0.01)
    sp = sp + FAR
    if entry == "points":
        j = jpipe.preprocess_points(sp, CFG.preprocess).down
        p = ppipe.preprocess_points(sp, PCFG.preprocess, device="cpu").down
    else:
        j = jpipe.preprocess_points_batch([sp], CFG.preprocess, full_normals=False)[0].down
        p = ppipe.preprocess_points_batch([sp], PCFG.preprocess, full_normals=False,
                                          device="cpu")[0].down
    assert float(np.abs(np.asarray(j.points)[np.asarray(j.mask)]).min()) > 1900
    _assert_features_agree(p, j)


def test_feature_stage_shift_is_an_exact_noop_near_the_origin():
    """Near the origin the centroid rounds to 0, so down_features equals the
    same scan on the unshifted cloud bit for bit."""
    sp, _, _ = make_benchmark_pair(3000, seed=3, sigma=0.01)
    down = pvoxel.voxel_downsample_host(sp, 0.3, device="cpu")
    pp = PCFG.preprocess
    got = ppipe.down_features(down, pp.normal_radius, pp.fpfh_radius,
                              normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn,
                              share_knn=True)
    assert not torch.round(down.centroid() / 64.0).any()
    pts = torch.where(down.mask[:, None], down.points, 1e9)
    d2, idx, valid = nn_topk(pts, pts, down.mask, down.mask, k=pp.fpfh_max_nn,
                             radius=pp.fpfh_radius, self_pairs=True)
    r2 = float(torch.tensor(pp.normal_radius, dtype=torch.float32) ** 2)
    k_n = pp.normal_max_nn
    want = normals_from_knn(down, idx[:, :k_n], valid[:, :k_n] & (d2[:, :k_n] <= r2))
    want = fpfh_from_knn(want, d2, idx, valid)
    torch.testing.assert_close(got.normals, want.normals, rtol=0, atol=0)
    torch.testing.assert_close(got.features, want.features, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Noise injection
# ---------------------------------------------------------------------------

NOISY = dataclasses.replace(CFG.preprocess, noise_sigma=0.05)
PNOISY = dataclasses.replace(PCFG.preprocess, noise_sigma=0.05)


def test_noise_sigma_matches_jax():
    """JAX's draws (normal(key, (cap, 3))) through the port: the noisy down
    points within one float32 rounding of JAX's (XLA may fuse the multiply
    and add), padding rows exactly 0, features those of the clean cloud."""
    sp, _, _ = make_benchmark_pair(3000, seed=1, sigma=0.01)
    key = jax.random.PRNGKey(11)
    j = jpipe.preprocess_points(sp, NOISY, key=key).down
    cap = j.points.shape[0]
    noise = _t(jax.random.normal(key, (cap, 3)))
    p = ppipe.preprocess_points(sp, PNOISY, noise=noise, device="cpu").down
    clean = ppipe.preprocess_points(sp, PCFG.preprocess, device="cpu").down
    m = p.mask.numpy()
    np.testing.assert_allclose(p.points.numpy(), np.asarray(j.points), rtol=0, atol=1e-6)
    assert not p.points.numpy()[~m].any()
    torch.testing.assert_close(p.features, clean.features, rtol=0, atol=0)
    d = (p.points - clean.points).numpy()[m]
    assert abs(d.std() - 0.05) < 0.005 and np.abs(d.mean(0)).max() < 0.01
    with pytest.raises(ValueError):
        ppipe.preprocess_points(sp, PNOISY, noise=noise[:-1], device="cpu")


def test_noise_sigma_batch_matches_jax(two_clouds):
    """Cloud i's noise along fold_in(key, i) in JAX; the port takes those
    draws per cloud, or draws them from a generator (reproducibly)."""
    key = jax.random.PRNGKey(5)
    jb = jpipe.preprocess_points_batch(two_clouds, NOISY, key=key, full_normals=False)
    cap = jb[0].down.points.shape[0]
    draws = [_t(jax.random.normal(jax.random.fold_in(key, i), (cap, 3))) for i in range(2)]
    pb = ppipe.preprocess_points_batch(two_clouds, PNOISY, noise=draws, full_normals=False,
                                       device="cpu")
    for j, p in zip(jb, pb):
        np.testing.assert_allclose(p.down.points.numpy(), np.asarray(j.down.points), rtol=0,
                                   atol=1e-6)
        assert not p.down.points.numpy()[~p.down.mask.numpy()].any()
    g = [ppipe.preprocess_points_batch(two_clouds, PNOISY, full_normals=False, device="cpu",
                                       generator=torch.Generator().manual_seed(3))
         for _ in range(2)]
    torch.testing.assert_close(g[0][1].down.points, g[1][1].down.points, rtol=0, atol=0)


@pytest.fixture(scope="module")
def featured_pair():
    """A 4000-point arch pair preprocessed by JAX and carried to the port."""
    sp, tp, T_true = make_benchmark_pair(4000, seed=0, sigma=0.01)
    sd, td = (jpipe.preprocess_points(x, CFG.preprocess).down for x in (sp, tp))
    return (sd, td, from_reference_arrays(_arrays(sd), device="cpu"),
            from_reference_arrays(_arrays(td), device="cpu"), T_true)


def _corr_draws(k_corr, ns, n_src, n_tgt):
    """JAX's noise draws from k_corr: split(k_corr, 3) -> uniform, randint,
    randint."""
    k1, k2, k3 = jax.random.split(k_corr, 3)
    return (_t(jax.random.uniform(k1, (ns,))), _t(jax.random.randint(k2, (ns,), 0, n_src)),
            _t(jax.random.randint(k3, (ns,), 0, n_tgt)))


def test_noise_ratio_matches_jax(featured_pair):
    """Mutual correspondences corrupted at r = 0.4 with JAX's draws: pairs
    and validity equal to JAX's."""
    sd, td, ps, pt, _ = featured_pair
    key = jax.random.PRNGKey(9)
    pj, vj = (np.asarray(x) for x in jcorr.feature_correspondences(
        sd, td, mutual_filter=True, noise_ratio=0.4, key=key))
    draws = _corr_draws(key, ps.capacity, int(ps.mask.sum()), int(pt.mask.sum()))
    pp, vp = pcorr.feature_correspondences(ps, pt, mutual_filter=True, noise_ratio=0.4,
                                           noise_draws=draws)
    clean, vc = pcorr.feature_correspondences(ps, pt, mutual_filter=True)
    assert (vp.numpy() == vj).mean() >= 0.999  # mutual near-ties (test_torch_large.py)
    both = vj & vp.numpy()
    assert (pp.numpy()[both] == pj[both]).all(1).mean() >= 0.999
    assert (pp != clean).any(1).numpy()[both].mean() > 0.2


def _two_mode_bits(key, n_chunks, k):
    rows = []
    for _ in range(n_chunks):
        key, k_samp = jax.random.split(key)
        rows.append(np.asarray(jax.random.bits(k_samp, (k, 2), jnp.uint32)))
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def test_global_registration_two_mode_noise_ratio_matches_jax(featured_pair):
    """The draws thread through the two-mode registration as JAX splits its
    key: k_corr for the correspondence noise, the rest for the RANSAC."""
    sd, td, ps, pt, T_true = featured_pair
    rc = dataclasses.replace(CFG.ransac, noise_ratio=0.25)
    prc = dataclasses.replace(PCFG.ransac, noise_ratio=0.25)
    key = jax.random.PRNGKey(21)
    outj = jransac.global_registration_two_mode(sd, td, rc, key)
    k_corr, k_ransac = jax.random.split(key)
    bits = _two_mode_bits(k_ransac, pransac.chunk_count(rc.max_iterations, rc.batch_size),
                          rc.batch_size)
    draws = _corr_draws(k_corr, ps.capacity, int(ps.mask.sum()), int(pt.mask.sum()))
    outp = pransac.global_registration_two_mode(ps, pt, prc, bits, noise_draws=draws)
    rj, rp = outj[0], outp[0]
    assert int(rp.iterations) == int(rj.iterations)
    assert abs(float(rp.fitness) - float(rj.fitness)) < 0.01
    M = rp.transformation.numpy()[:3, :3] @ np.asarray(rj.transformation)[:3, :3].T
    assert np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))) < 0.05
    M = rp.transformation.numpy()[:3, :3] @ T_true[:3, :3].T  # RANSAC alone, no ICP
    assert np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))) < 5.0


# ---------------------------------------------------------------------------
# Dense features (preprocess/dense.py)
# ---------------------------------------------------------------------------


def _dense_cloud(n_raw, seed, cap):
    raw = dental_arch_cloud(n_raw, seed=seed)
    down = jvoxel.voxel_downsample_host(raw, 0.3)
    m = np.asarray(down.mask)
    jc = j_from_numpy(np.asarray(down.points)[m], capacity=cap)
    return jc, from_reference_arrays(_arrays(jc), device="cpu")


@pytest.mark.parametrize("caps", [(30, 100), (100, 30), (0, 0)], ids=["default", "inverted",
                                                                      "uncapped"])
def test_down_features_dense_matches_jax(caps):
    """JAX's cap edge cases (tests/test_preprocess.py): capped, inverted and
    uncapped.  Normals |dot| > 0.9999 on every valid row; FPFH relative L1
    median < 2e-3, max < 0.1 (the k-th-distance threshold keeps or drops a
    boundary neighbour on last-bit differences of the distances); masked
    rows 0, every value finite."""
    kn, kf = caps
    jc, pc = _dense_cloud(4000, 3, 768)
    pp = CFG.preprocess
    j = jdense.down_features_dense(jc, jnp.float32(pp.normal_radius), jnp.float32(pp.fpfh_radius),
                                   normal_max_nn=kn, fpfh_max_nn=kf)
    p = pdense.down_features_dense(pc, pp.normal_radius, pp.fpfh_radius, normal_max_nn=kn,
                                   fpfh_max_nn=kf)
    m = np.asarray(jc.mask)
    assert np.isfinite(p.features.numpy()).all() and np.isfinite(p.normals.numpy()).all()
    dots = np.sum(p.normals.numpy() * np.asarray(j.normals), axis=1)[m]
    assert dots.min() > 0.9999
    fj, fp = np.asarray(j.features)[m], p.features.numpy()[m]
    rel = np.abs(fp - fj).sum(1) / np.abs(fj).sum(1)
    assert np.median(rel) < 2e-3 and rel.max() < 0.1
    assert not p.features.numpy()[~m].any() and not p.normals.numpy()[~m].any()


def test_down_features_dense_chunks_change_nothing(monkeypatch):
    """The SPFH column chunks sum integer bin counts, so the chunk width
    leaves the features unchanged (a cloud of a non-multiple of CHUNK rows,
    and one narrower than a chunk)."""
    _, pc = _dense_cloud(2000, 5, 640)
    pp = PCFG.preprocess
    kw = dict(normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn)
    a = pdense.down_features_dense(pc, pp.normal_radius, pp.fpfh_radius, **kw)
    monkeypatch.setattr(pdense, "CHUNK", 1024)
    b = pdense.down_features_dense(pc, pp.normal_radius, pp.fpfh_radius, **kw)
    torch.testing.assert_close(a.features, b.features, rtol=0, atol=1e-4)
    torch.testing.assert_close(a.normals, b.normals, rtol=0, atol=0)
