"""Port parity for tpu3dm_torch's disk-to-result stream
(registration/stream.py) and its batched dense features, on the CPU at the
JAX stream tests' size: 1500-point clouds of the three families, 512
hypotheses, 4 ICP iterations.

Randomness crosses as bits: JAX gives manifest pair i the key
``split(PRNGKey(0), P)[i]`` and its fused step draws chunk c of restart r
from ``split(split(key_i, R)[r], n_chunks)[c]``; the retry's j-th pair takes
``split(PRNGKey(0xE5CA), w_pad)[j]``, with w_pad the retried count rounded
up to 16.  The port takes those bits as ``pair_bits`` / ``retry_bits``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.cloud import PointCloud as JCloud
from tpu3dm.core.config import PipelineConfig
from tpu3dm.preprocess import dense as jdense
from tpu3dm.registration import stream as jstream
from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.preprocess import dense as pdense
from tpu3dm_torch.registration import stream as pstream

from test_torch_ransac_options import jax_chunk_bits, jax_extra_bits
from test_torch_rescue import _rescue_bits, _rot_apart_deg

CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
N_POINTS = 1500
KW = dict(ransac_iterations=512, icp_iterations=4)
DOWN_CAP = 768  # the downsampled 1500-point clouds hold up to ~550 points


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair_bits(n_pairs, restarts=0, m_s=256):
    """[P, (R,) 1, m_s]: each manifest pair's fused-step bits from JAX's
    positional keys split(PRNGKey(0), P)."""
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), n_pairs))
    if restarts:
        return _rescue_bits(keys, restarts, m_s)
    return torch.from_numpy(np.stack([jax_chunk_bits(k, 1, (m_s,)) for k in keys]))


def _assert_poses_match(res, ref, pairs=slice(None)):
    """The fused-step tolerances of tests/test_torch_batch.py."""
    T, R = res.transforms[pairs], ref.transforms[pairs]
    assert _rot_apart_deg(T, R).max() < 0.05
    assert np.abs(T[:, :3, 3] - R[:, :3, 3]).max() < 5e-3
    np.testing.assert_allclose(res.ransac_fitness[pairs], ref.ransac_fitness[pairs], atol=1e-6)
    np.testing.assert_allclose(res.icp_rmse[pairs], ref.icp_rmse[pairs], atol=1e-4)


def _assert_poses_agree(Ta, Tb):
    """JAX's fused-against-generic bounds (tests/test_stream.py): rotation
    within 0.5 deg, translation within 0.02."""
    assert _rot_apart_deg(Ta, Tb).max() < 0.5
    assert np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max() < 0.02


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Five mixed pairs (arch, plate, scan, arch, plate) on disk."""
    return pstream.make_stream_manifest(tmp_path_factory.mktemp("stream"), 5,
                                        n_points=N_POINTS, sigma=0.005, family="mix")


# The mix manifest's scan pairs.  A scan cloud's flying pixels have one or two
# neighbours, so their covariance is near rank 1 and its smallest eigenvector
# is decided by the last bits of the sums: the two packages' kNN features of
# the scan clouds differ (least normal dot -0.05, FPFH relative L1 up to 0.86
# on ~70 of ~500 rows, against <= 0.01 on the arch and plate clouds), so the
# correspondences do, and the pair is held to JAX's fused-against-generic
# bounds rather than the fused step's.
SCAN = [2]
CLEAN = [0, 1, 3, 4]


@pytest.fixture(scope="module")
def generic(manifest):
    """The port's generic stream at window 2, with JAX's per-pair bits."""
    paths = manifest[0]
    return pstream.stream_register_pairs(paths, PCFG, window=2, pair_bits=_pair_bits(len(paths)),
                                         device="cpu", **KW)


def test_make_stream_manifest_matches_jax(manifest, tmp_path):
    paths, trues, moments = manifest
    jpaths, jtrues, jmoments = jstream.make_stream_manifest(tmp_path, 5, n_points=N_POINTS,
                                                            sigma=0.005, family="mix")
    for (a, b), (ja, jb) in zip(paths, jpaths):
        assert open(a, "rb").read() == open(ja, "rb").read()
        assert open(b, "rb").read() == open(jb, "rb").read()
    np.testing.assert_array_equal(np.stack(trues), np.stack(jtrues))
    for m, jm in zip(moments, jmoments):
        np.testing.assert_array_equal(m[0], jm[0])
        np.testing.assert_array_equal(m[1], jm[1])


def test_generic_stream_matches_jax_and_is_window_invariant(manifest, generic):
    """JAX's generic stream (window 2, its default key) against the port's
    with the rebuilt bits: the same buckets, the arch and plate pairs at the
    fused-step tolerances, the scan pair (see SCAN) at JAX's
    fused-against-generic bounds; the port's windows 2 and 4 equal bit for
    bit; the gate passes."""
    paths, trues, moments = manifest
    jres = jstream.stream_register_pairs(paths, CFG, window=2, **KW)
    assert generic.window_pairs == [2, 2, 1]
    assert generic.bucket_of_pair == jres.bucket_of_pair
    _assert_poses_match(generic, jres, CLEAN)
    _assert_poses_agree(generic.transforms[SCAN], jres.transforms[SCAN])
    res4 = pstream.stream_register_pairs(paths, PCFG, window=4,
                                         pair_bits=_pair_bits(len(paths)), device="cpu", **KW)
    assert res4.window_pairs == [4, 1]
    np.testing.assert_array_equal(res4.transforms, generic.transforms)
    np.testing.assert_array_equal(res4.ransac_fitness, generic.ransac_fitness)
    assert pstream.stream_quality(generic, trues, moments)["quality_ok"]
    assert generic.steady_pairs_per_sec is not None and generic.fresh_pairs_per_sec > 0


def test_generic_stream_generator_draws_pair_after_pair(manifest):
    """Without pair_bits, pair i takes the generator's i-th draw in manifest
    order, whatever the window."""
    paths = manifest[0][:3]
    a, b = (pstream.stream_register_pairs(paths, PCFG, window=w,
                                          generator=torch.Generator().manual_seed(9),
                                          device="cpu", **KW) for w in (1, 3))
    np.testing.assert_array_equal(a.transforms, b.transforms)


def test_fused_stream_agrees_with_generic_and_is_window_invariant(manifest, generic):
    """The fused path (dense features, every pair at down_cap, a short last
    window) within JAX's fused-vs-generic bounds (0.5 deg, 0.02) of the
    generic path on the same bits; windows 2 and 3 equal bit for bit."""
    paths, trues, moments = manifest
    bits = _pair_bits(len(paths))
    fused = {w: pstream.stream_register_pairs(paths, PCFG, window=w, down_cap=DOWN_CAP,
                                              fuse_device=True, pair_bits=bits, device="cpu",
                                              **KW)
             for w in (2, 3)}
    assert fused[2].window_pairs == [2, 2, 1] and fused[3].window_pairs == [3, 2]
    assert fused[2].bucket_of_pair == [DOWN_CAP] * len(paths)
    assert len(fused[2].ingest_seconds) == 3
    np.testing.assert_array_equal(fused[2].transforms, fused[3].transforms)
    assert pstream.stream_quality(fused[2], trues, moments)["quality_ok"]
    _assert_poses_agree(fused[2].transforms, generic.transforms)


# ---------------------------------------------------------------------------
# Batched dense features
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window_clouds(manifest):
    """The first window's four clouds as the fused path ingests them:
    [4, DOWN_CAP] points and masks."""
    hosts = pstream._iter_host_windows(manifest[0], 0.3, window=2, workers=2, down_cap=DOWN_CAP)
    _, pts, masks, _ = next(hosts)
    hosts.close()
    return pts, masks


def _dense(pts, masks, **kw):
    pp = PCFG.preprocess
    pc = PointCloud(torch.from_numpy(pts), torch.from_numpy(masks),
                    torch.zeros(pts.shape, dtype=torch.float32), torch.zeros(pts.shape[:2] + (0,)))
    return pdense.down_features_dense(pc, pp.normal_radius, pp.fpfh_radius,
                                      normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn)


def test_batched_dense_features_equal_per_cloud(window_clouds, monkeypatch):
    """Batched, per cloud, reordered and cut into chunks of one and three
    clouds: a cloud's normals and features are the same bits."""
    pts, masks = window_clouds
    whole = _dense(pts, masks)
    rev = _dense(pts[::-1].copy(), masks[::-1].copy())
    for i in range(len(pts)):
        one = _dense(pts[i:i + 1], masks[i:i + 1])
        for f in ("normals", "features"):
            assert torch.equal(getattr(whole, f)[i], getattr(one, f)[0])
            assert torch.equal(getattr(whole, f)[i], getattr(rev, f)[len(pts) - 1 - i])
    for per_chunk in (1, 3):
        monkeypatch.setattr(pdense, "DENSE_PLANE_BYTES", 4 * DOWN_CAP * DOWN_CAP * per_chunk)
        chunked = _dense(pts, masks)
        assert torch.equal(chunked.features, whole.features)
        assert torch.equal(chunked.normals, whole.normals)


def test_batched_dense_features_match_jax_vmap(window_clouds):
    """JAX's vmapped down_features_dense (the fused stream's feature stage)
    within test_torch_ingest.py's dense bounds: normals |dot| > 0.9999 on
    every valid row, FPFH relative L1 median < 2e-3 and max < 0.1, masked
    rows 0."""
    pts, masks = window_clouds
    pp = CFG.preprocess
    clouds = JCloud(points=jnp.asarray(pts), mask=jnp.asarray(masks),
                    normals=jnp.zeros(pts.shape), features=jnp.zeros(pts.shape[:2] + (0,)))
    j = jax.vmap(lambda pc: jdense.down_features_dense(
        pc, jnp.float32(pp.normal_radius), jnp.float32(pp.fpfh_radius),
        normal_max_nn=pp.normal_max_nn, fpfh_max_nn=pp.fpfh_max_nn))(clouds)
    p = _dense(pts, masks)
    m = masks
    dots = np.sum(p.normals.numpy() * np.asarray(j.normals), axis=-1)[m]
    assert dots.min() > 0.9999
    fj, fp = np.asarray(j.features)[m], p.features.numpy()[m]
    rel = np.abs(fp - fj).sum(-1) / np.abs(fj).sum(-1)
    assert np.median(rel) < 2e-3 and rel.max() < 0.1
    assert not p.features.numpy()[~m].any() and not p.normals.numpy()[~m].any()


# ---------------------------------------------------------------------------
# The retry, the gate, the arguments
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_symmetry_probe_retry_matches_jax(tmp_path):
    """retry_below_fitness=1.0 escalates every pair of a 4-pair mix (2
    rescue restarts on the main path), against JAX's fused stream: JAX's
    retry bits rebuilt at w_pad = 16, the fused-step tolerances, every pair
    within 2 deg of its truth."""
    paths, trues, _ = pstream.make_stream_manifest(tmp_path, 4, n_points=N_POINTS, sigma=0.01,
                                                   family="mix")
    kw = dict(window=2, down_cap=DOWN_CAP, fuse_device=True, ransac_iterations=512,
              icp_iterations=4, icp_solves_per_nn=2, rescue_restarts=2,
              retry_below_fitness=1.0)
    jres = jstream.stream_register_pairs(paths, CFG, **kw)
    rkeys = np.asarray(jax.random.split(jax.random.PRNGKey(0xE5CA), 16))[:4]
    res = pstream.stream_register_pairs(
        paths, PCFG, pair_bits=_pair_bits(4, restarts=2), device="cpu",
        retry_bits=torch.from_numpy(np.stack([jax_chunk_bits(k, 1, (DOWN_CAP,))
                                              for k in rkeys])),
        retry_extra_bits=torch.from_numpy(np.stack([jax_extra_bits(k, 3, (DOWN_CAP,))
                                                    for k in rkeys])),
        **kw)
    assert res.retry_pairs == jres.retry_pairs == [0, 1, 2, 3]
    assert res.retry_seconds > 0
    _assert_poses_match(res, jres)
    assert _rot_apart_deg(res.transforms, np.stack(trues)).max() < 2.0


def test_retry_bits_shapes_and_generator():
    """The retry's bits: the caller's first n rows (fewer raise), or drawn
    pair after pair from a generator."""
    bits, extra = pstream._retry_bits(3, 64, None, None, torch.Generator().manual_seed(1))
    assert bits.shape == (3, 1, 64) and extra.shape == (3, 3, 64)
    again = pstream._retry_bits(2, 64, None, None, torch.Generator().manual_seed(1))
    assert torch.equal(again[0], bits[:2]) and torch.equal(again[1], extra[:2])
    got = pstream._retry_bits(2, 64, bits, extra, None)
    assert torch.equal(got[0], bits[:2])
    with pytest.raises(ValueError, match="retry_bits"):
        pstream._retry_bits(4, 64, bits, extra, None)
    with pytest.raises(ValueError, match="retry_extra_bits"):
        pstream._retry_bits(2, 64, bits, None, None)


def test_stream_quality_equals_jax():
    """The gate on the same transforms: aliased pairs over 2 deg within and
    over the budget, and a near-miss translation."""
    rng = np.random.default_rng(4)
    n = 400
    trues = [np.eye(4) for _ in range(n)]
    moments = [(rng.normal(size=3), np.diag(rng.uniform(1, 3, size=3))) for _ in range(n)]
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, 3] = rng.normal(scale=0.01, size=(n, 3))
    fit = rng.uniform(0.1, 0.9, n).astype(np.float32)
    for bad in ([], [7], [7, 99], [7, 99, 250]):
        Tb = T.copy()
        for i in bad:
            Tb[i, :3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
        fields = dict(transforms=Tb, ransac_fitness=fit, icp_rmse=fit, bucket_of_pair=[],
                      window_pairs=[], window_done_s=[], total_seconds=0.0,
                      fresh_pairs_per_sec=0.0, steady_pairs_per_sec=None)
        got = pstream.stream_quality(pstream.StreamResult(**fields), trues, moments)
        want = jstream.stream_quality(jstream.StreamResult(**fields), trues, moments)
        assert got == want
        assert got["quality_ok"] == (len(bad) <= 2)


def test_stream_argument_errors(manifest, tmp_path):
    paths = manifest[0]
    with pytest.raises(ValueError, match="down_cap"):
        pstream.stream_register_pairs(paths, PCFG, window=2, fuse_device=True, device="cpu")
    for window in (0, -1):
        for fuse in (False, True):
            with pytest.raises(ValueError, match="window"):
                pstream.stream_register_pairs(paths, PCFG, window=window, down_cap=DOWN_CAP,
                                              fuse_device=fuse, device="cpu")
    with pytest.raises(ValueError, match="exceed down_cap=256"):
        pstream.stream_register_pairs(paths[:1], PCFG, window=1, down_cap=256,
                                      fuse_device=True, device="cpu", **KW)
    with pytest.raises(ValueError, match="pair_bits"):
        pstream.stream_register_pairs(paths, PCFG, window=2, pair_bits=_pair_bits(2),
                                      device="cpu", **KW)


def test_stream_entry_points_raise_without_cuda(manifest, monkeypatch):
    from tpu3dm_torch.io import loader

    paths = manifest[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: pstream.stream_register_pairs(paths, PCFG, window=2),
        lambda: pstream.stream_register_pairs(paths, PCFG, window=2, down_cap=DOWN_CAP,
                                              fuse_device=True),
        lambda: pstream.measure_fused_device_rate(PCFG, window=2, down_cap=DOWN_CAP),
        lambda: loader.preprocess_files_batch(list(paths[0])),
        lambda: loader.iter_preprocessed_windows(paths, PCFG.preprocess, window=2),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_measure_fused_device_rate_runs_on_the_cpu():
    """Its timing is the device's only on a card; on the CPU it checks the
    call: random clouds, one window, a positive rate."""
    rate = pstream.measure_fused_device_rate(
        PCFG, window=2, down_cap=256, ransac_iterations=256,
        icp_iterations=2, reps=1, device="cpu")
    assert rate > 0
