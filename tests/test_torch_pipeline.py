"""Port parity for tpu3dm_torch's single-pair pipeline
(registration/pipeline.py) and what it reads: single-mode RANSAC
(registration/ransac.py), ``load_cloud``, ``fit_rigid_svd``,
``information_matrix``, the rest of ``core/se3.py`` and ``to_numpy``, on
the CPU at small shapes.

RANSAC gets JAX's own bits, rebuilt from its key schedule: a chunk draws
``bits(k, (K, 2))`` after ``key, k = split(key)``; ``global_registration``
first splits off the correspondence key, and the verified restarts fold the
restart into the key (tests/test_torch_large.py).  Counts must be equal and
poses within 0.05 deg / 5e-3; the full pipeline's poses (full-resolution
ICP) are held to the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core import se3 as jse3
from tpu3dm.core.cloud import to_numpy as j_to_numpy
from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.preprocess.pipeline import preprocess_points as j_preprocess
from tpu3dm.registration import pipeline as jpipe
from tpu3dm.registration.correspondence import feature_correspondences, gather_pairs
from tpu3dm.registration.evaluate import information_matrix as j_information_matrix
from tpu3dm.registration.kabsch import fit_rigid_svd as j_fit_rigid_svd
from tpu3dm.registration.ransac import global_registration as j_global_registration
from tpu3dm.registration.ransac import ransac_from_correspondences as j_ransac
from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import from_reference_arrays, to_numpy
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.io.ply import write_ply
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud, load_cloud
from tpu3dm_torch.registration import pipeline as ppipe
from tpu3dm_torch.registration.evaluate import information_matrix
from tpu3dm_torch.registration.kabsch import fit_rigid_svd
from tpu3dm_torch.registration.ransac import (
    chunk_count,
    global_registration,
    ransac_from_correspondences,
)

CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
N_POINTS = 3000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rot_err_deg(Ta, Tb):
    M = np.asarray(Ta, np.float64)[:3, :3] @ np.asarray(Tb, np.float64)[:3, :3].T
    return float(np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))))


def _assert_close(Tp, Tj):
    Tp, Tj = np.asarray(Tp), np.asarray(Tj)
    assert _rot_err_deg(Tp, Tj) < 0.05
    assert np.abs(Tp[:3, 3] - Tj[:3, 3]).max() < 5e-3


def _chunk_bits(key, n_chunks, k):
    """JAX's single-mode schedule: (key, k_samp) = split(key); bits(k_samp, (k, 2))."""
    rows = []
    for _ in range(n_chunks):
        key, k_samp = jax.random.split(key)
        rows.append(np.asarray(jax.random.bits(k_samp, (k, 2), jnp.uint32)))
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def _registration_bits(key, cfg):
    """global_registration's: the correspondence key split off first."""
    _, key = jax.random.split(key)
    return _chunk_bits(key, chunk_count(cfg.max_iterations, cfg.batch_size), cfg.batch_size)


def _restart_bits(key, restarts, cfg):
    """coarse_pose_with_verification's: restart r folds r into the key, and
    the two-mode registration splits off the correspondence key."""
    return torch.stack([_registration_bits(jax.random.fold_in(key, r), cfg)
                        for r in range(restarts)])


def _arrays(pc):
    return {f: np.asarray(getattr(pc, f)) for f in ("points", "normals", "features", "mask")}


def _port(jproc):
    return ProcessedCloud(full=from_reference_arrays(_arrays(jproc.full), device="cpu"),
                          down=from_reference_arrays(_arrays(jproc.down), device="cpu"),
                          voxel_size=jproc.voxel_size)


@pytest.fixture(scope="module")
def arch():
    """An arch pair preprocessed by JAX (full normals included), and the
    same clouds carried to the port."""
    sp, tp, T_true = make_benchmark_pair(N_POINTS, seed=1, sigma=0.005)
    js, jt = j_preprocess(sp, CFG.preprocess), j_preprocess(tp, CFG.preprocess)
    return dict(sp=sp, tp=tp, T_true=T_true, js=js, jt=jt, ps=_port(js), pt=_port(jt))


def test_ransac_from_correspondences_matches_jax(arch):
    """Mutual FPFH correspondences computed once, both RANSACs on them with
    JAX's bits: the same count and chunks, poses within the bounds."""
    js, jt = arch["js"].down, arch["jt"].down
    pairs, valid = feature_correspondences(js, jt, mutual_filter=True)
    p_all, q_all = gather_pairs(js, jt, pairs)
    r = CFG.ransac
    key = jax.random.PRNGKey(11)
    for early_stop, k in ((True, r.batch_size), (False, 512)):
        kw = dict(dist_thresh=r.dist_thresh, max_iterations=4 * k, batch_size=k,
                  early_stop=early_stop)
        jres = j_ransac(p_all, q_all, valid, key, **kw)
        pres = ransac_from_correspondences(
            torch.from_numpy(np.array(p_all)), torch.from_numpy(np.array(q_all)),
            torch.from_numpy(np.array(valid)), _chunk_bits(key, 4, k), **kw)
        assert int(pres.iterations) == int(jres.iterations)
        np.testing.assert_allclose(float(pres.fitness), float(jres.fitness), atol=1e-6)
        np.testing.assert_allclose(float(pres.inlier_rmse), float(jres.inlier_rmse), atol=1e-4)
        _assert_close(pres.transformation, jres.transformation)
        assert _rot_err_deg(pres.transformation, arch["T_true"]) < 2.0


def test_ransac_from_correspondences_checks_bits():
    p = torch.zeros((16, 3))
    with pytest.raises(ValueError, match="sample_bits"):
        ransac_from_correspondences(p, p, torch.ones(16, dtype=torch.bool),
                                    torch.zeros((1, 8, 2), dtype=torch.int64), dist_thresh=0.1,
                                    max_iterations=64, batch_size=32)


def test_global_registration_matches_jax(arch):
    key = jax.random.PRNGKey(5)
    jres = j_global_registration(arch["js"].down, arch["jt"].down, CFG.ransac, key)
    pres = global_registration(arch["ps"].down, arch["pt"].down, PCFG.ransac,
                               _registration_bits(key, PCFG.ransac))
    assert int(pres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(float(pres.fitness), float(jres.fitness), atol=1e-6)
    _assert_close(pres.transformation, jres.transformation)


def test_global_registration_takes_only_3_point_samples(arch):
    import dataclasses

    with pytest.raises(NotImplementedError, match="sample_size"):
        global_registration(arch["ps"].down, arch["pt"].down,
                            dataclasses.replace(PCFG.ransac, sample_size=4))


@pytest.mark.parametrize("restarts", [1, 4])
def test_register_pair_matches_jax(arch, restarts):
    """RANSAC (single or verified restarts) then full-resolution ICP on the
    same clouds with JAX's bits."""
    key = jax.random.PRNGKey(0)
    jres = jpipe.register_pair(arch["js"], arch["jt"], CFG, key=key, restarts=restarts)
    bits = (_registration_bits(key, PCFG.ransac) if restarts == 1
            else _restart_bits(key, restarts, PCFG.ransac))
    pres = ppipe.register_pair(arch["ps"], arch["pt"], PCFG, sample_bits=bits,
                               restarts=restarts)
    np.testing.assert_allclose(float(pres.ransac.fitness), float(jres.ransac.fitness), atol=1e-6)
    _assert_close(pres.ransac.transformation, jres.ransac.transformation)
    _assert_close(pres.transformation, jres.transformation)
    np.testing.assert_allclose(float(pres.icp.fitness), float(jres.icp.fitness), atol=1e-3)
    np.testing.assert_allclose(float(pres.icp.inlier_rmse), float(jres.icp.inlier_rmse),
                               atol=1e-4)
    assert _rot_err_deg(pres.transformation, arch["T_true"]) < 2.0
    assert pres.source is arch["ps"] and pres.target is arch["pt"]


def test_register_arrays_and_files(arch, tmp_path):
    """register_arrays preprocesses on the port and lands within the CPU
    agreement bound of JAX's; register_files on the same points written as
    PLYs gives the same bits; both of load_cloud's errors."""
    key = jax.random.PRNGKey(0)
    bits = _registration_bits(key, PCFG.ransac)
    sp32, tp32 = arch["sp"].astype(np.float32), arch["tp"].astype(np.float32)
    jres = jpipe.register_arrays(sp32, tp32, CFG, key=key)
    pres = ppipe.register_arrays(sp32, tp32, PCFG, sample_bits=bits, device="cpu")
    assert _rot_err_deg(pres.transformation, jres.transformation) < 0.5
    assert np.abs(np.asarray(pres.transformation)[:3, 3]
                  - np.asarray(jres.transformation)[:3, 3]).max() < 0.02
    assert _rot_err_deg(pres.transformation, arch["T_true"]) < 2.0
    sp, tp = tmp_path / "src.ply", tmp_path / "tgt.ply"
    write_ply(sp, sp32)
    write_ply(tp, tp32)
    fres = ppipe.register_files(sp, tp, PCFG, sample_bits=bits, device="cpu")
    assert torch.equal(fres.transformation, pres.transformation)
    with pytest.raises(FileNotFoundError):
        ppipe.register_files(tmp_path / "missing.ply", tp, PCFG, device="cpu")
    other = tmp_path / "cloud.xyz"
    other.write_text("0 0 0\n")
    with pytest.raises(TypeError):
        ppipe.register_files(other, tp, PCFG, device="cpu")
    with pytest.raises(TypeError):
        load_cloud(other, PCFG.preprocess, device="cpu")


def test_pipeline_entry_points_need_cuda_by_default(arch, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppipe.register_arrays(arch["sp"], arch["tp"], PCFG)
    path = tmp_path / "a.ply"
    write_ply(path, arch["sp"].astype(np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ppipe.register_files(path, path, PCFG)


def test_fit_rigid_svd_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(5, 40, 3)).astype(np.float32)
    R = np.asarray(jse3.euler_zyx(jnp.asarray(rng.uniform(-1, 1, size=(5, 3)), jnp.float32)))
    q = (p @ np.swapaxes(R, -1, -2) + rng.normal(size=(5, 1, 3)) + 0.01 * rng.normal(
        size=p.shape)).astype(np.float32)
    q[4] = p[4] @ np.diag([1.0, 1.0, -1.0]).astype(np.float32)  # a reflection to fix
    got = fit_rigid_svd(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    want = np.asarray(j_fit_rigid_svd(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(np.linalg.det(got[:, :3, :3]) > 0)


def test_information_matrix_matches_jax(arch):
    T = np.asarray(arch["T_true"], np.float32)
    want = np.asarray(j_information_matrix(arch["js"].down, arch["jt"].down, 0.12, T))
    got = information_matrix(arch["ps"].down, arch["pt"].down, 0.12, torch.from_numpy(T))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-2)
    assert got.shape == (6, 6) and got[0, 0] > 0


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(3)
    ang = rng.uniform(-1.0, 1.0, size=(4, 3)).astype(np.float32)
    R = se3.euler_zyx(torch.from_numpy(ang))
    np.testing.assert_allclose(R.numpy(), np.asarray(jse3.euler_zyx(jnp.asarray(ang))), atol=1e-6)
    t = rng.normal(size=3).astype(np.float32)
    T = se3.make(R[0], torch.from_numpy(t))
    np.testing.assert_array_equal(T.numpy(), np.asarray(jse3.make(jnp.asarray(R[0].numpy()),
                                                                 jnp.asarray(t))))
    assert torch.equal(se3.rotation(T), R[0]) and torch.equal(se3.translation(T),
                                                              torch.from_numpy(t))
    assert torch.equal(se3.identity(), torch.eye(4))
    U = se3.make(R[1], torch.zeros(3))
    np.testing.assert_allclose(se3.compose(T, U).numpy(),
                               np.asarray(jse3.compose(jnp.asarray(T.numpy()),
                                                       jnp.asarray(U.numpy()))), atol=1e-6)
    got = se3.rotation_geodesic_deg(R[0], R[1:])
    want = np.asarray(jse3.rotation_geodesic_deg(jnp.asarray(R[0].numpy()),
                                                 jnp.asarray(R[1:].numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_random_transform_about_its_center():
    """Angles within +-max_angle, translation within +-max_translation, the
    rotation about ``center``; the same generator state gives the same
    transform."""
    center = torch.tensor([1.0, -2.0, 3.0])
    T = se3.random_transform(torch.Generator().manual_seed(4), center, max_angle=0.3,
                             max_translation=0.05)
    again = se3.random_transform(torch.Generator().manual_seed(4), center, max_angle=0.3,
                                 max_translation=0.05)
    assert torch.equal(T, again)
    R = T[:3, :3]
    assert torch.allclose(R @ R.T, torch.eye(3), atol=1e-6)
    moved_center = R @ center + T[:3, 3]
    assert (moved_center - center).abs().max() <= 0.05 + 1e-6
    assert float(se3.rotation_geodesic_deg(R, torch.eye(3))) < np.degrees(0.3 * np.sqrt(3))


def test_to_numpy_matches_jax(arch):
    for jc, pc in ((arch["js"].down, arch["ps"].down), (arch["js"].full, arch["ps"].full)):
        want, got = j_to_numpy(jc), to_numpy(pc)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
