"""Port parity for the sharded large-cloud ICP (parallel/sharded_icp.py) and
``register_arrays_large(mesh=...)``, on the CPU.

Each case of tests/test_sharded_icp.py runs through JAX's
``icp_refine_sharded`` on its 8 simulated CPU devices and the port's on
``[torch.device("cpu")] * 8``, with the same numpy clouds and normals.
Bounds (the ordered sums differ from XLA's in order, so the poses differ
in the last bits; measured 4e-8 point-to-plane, 1e-8 point-to-point, 1.1e-6
on the block-sparse ring):

  - transforms within 1e-5 of JAX's, the same iteration count, fitness
    within 1e-3, and JAX's own bounds against the truth or the
    single-device refinement;
  - the degenerate cases (no overlap, 5 points, coplanar, the positive
    octant with uneven counts) finite, with JAX's fitness and identity
    bounds;
  - the port's sharded ICP is bit-equal to itself across a repeated call,
    and within 1e-4 of the port's single-device ``icp_refine``;
  - ``register_arrays_large(mesh=...)`` (the dense ring) at 20,000 points
    with JAX's coarse bits: within 0.1 deg and 5e-3 of JAX's,
    both through bench.py's large gate (rotation < 2 deg, RMSE < 0.01).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3dm.native
from tpu3dm.core import se3 as jse3
from tpu3dm.core.cloud import from_numpy as j_from_numpy
from tpu3dm.core.config import PipelineConfig as JConfig
from tpu3dm.io.synthetic import dental_arch_cloud, make_benchmark_pair
from tpu3dm.ops.nn import nn_search as j_nn_search
from tpu3dm.parallel.mesh import make_mesh as j_make_mesh
from tpu3dm.parallel.sharded_icp import icp_refine_sharded as j_icp_sharded
from tpu3dm.preprocess.normals import estimate_normals
from tpu3dm.preprocess.voxel import voxel_downsample_host
from tpu3dm.registration import large as jlarge
from tpu3dm.registration import ransac as jransac
from tpu3dm_torch.core.cloud import from_numpy as p_from_numpy
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.parallel.mesh import make_mesh
from tpu3dm_torch.parallel.sharded_icp import icp_refine_sharded
from tpu3dm_torch.registration import large as plarge
from tpu3dm_torch.registration import ransac as pransac
from tpu3dm_torch.registration.icp import icp_refine

JCFG, PCFG = JConfig.with_voxel_size(0.3), PConfig.with_voxel_size(0.3)


@pytest.fixture(scope="module", autouse=True)
def native_tier():
    """The JAX native tier loaded (both packages' KD partitions are then the
    same C++; see tests/test_torch_host.py:native_tier)."""
    if not tpu3dm.native.available():
        tpu3dm.native._tried = False
        tpu3dm.native._lib = None
        tpu3dm.native.lib()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(1, 8), make_mesh(1, 8, devices=[torch.device("cpu")] * 8)


def _rigid(seed, angle, trans):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * angle
    t = rng.uniform(-trans, trans, 3)
    return np.asarray(jse3.exp_se3(jnp.asarray(np.r_[t, w], jnp.float32)))


def _rot_err_deg(Ta, Tb):
    M = np.asarray(Ta, np.float64)[:3, :3] @ np.asarray(Tb, np.float64)[:3, :3].T
    return float(np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))))


def _both(meshes, src, tgt, **kw):
    """(JAX result, port result) of the sharded ICP on the same inputs."""
    jm, pm = meshes
    rj = j_icp_sharded(jm, src, tgt, jnp.eye(4), **kw)
    rp = icp_refine_sharded(pm, src, tgt, np.eye(4), **kw)
    return rj, rp


def _close(rj, rp):
    Tj, Tp = np.asarray(rj.transformation), rp.transformation.numpy()
    assert np.all(np.isfinite(Tp))
    np.testing.assert_allclose(Tp, Tj, atol=1e-5)
    assert int(rp.iterations) == int(rj.iterations)
    assert abs(float(rp.fitness) - float(rj.fitness)) < 1e-3
    return Tp


def _target_normals(tgt_pts):
    pc = estimate_normals(j_from_numpy(tgt_pts), radius=0.6)
    return np.asarray(pc.normals)[: tgt_pts.shape[0]]


def test_point_to_plane_matches_jax_and_single_device(meshes):
    pts = dental_arch_cloud(5000, seed=0)
    T_true = _rigid(1, angle=0.08, trans=0.08)
    tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    nrm = _target_normals(tgt)
    rj, rp = _both(meshes, pts, tgt, tgt_normals=nrm, dist_thresh=0.4, max_iterations=30)
    Tp = _close(rj, rp)
    np.testing.assert_allclose(Tp, T_true, atol=1e-3)
    assert float(rp.fitness) > 0.99
    # The port's single-device ICP on the same normals (JAX's test: 1e-4).
    tgt_pc = p_from_numpy(tgt, device="cpu").with_(normals=torch.from_numpy(nrm))
    r1 = icp_refine(p_from_numpy(pts, device="cpu"), tgt_pc, torch.eye(4), dist_thresh=0.4,
                    max_iterations=30)
    np.testing.assert_allclose(Tp, r1.transformation.numpy(), atol=1e-4)
    again = icp_refine_sharded(meshes[1], pts, tgt, np.eye(4), tgt_normals=nrm,
                               dist_thresh=0.4, max_iterations=30)
    assert torch.equal(again.transformation, rp.transformation)


def test_point_to_point_matches_jax(meshes):
    pts = dental_arch_cloud(4000, seed=2)
    T_true = _rigid(3, angle=0.05, trans=0.05)
    tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    rj, rp = _both(meshes, pts, tgt, dist_thresh=0.4, max_iterations=40, point_to_plane=False)
    Tp = _close(rj, rp)
    np.testing.assert_allclose(Tp, T_true, atol=2e-2)
    assert float(rp.fitness) > 0.99


def test_uneven_sizes_and_masks_match_jax(meshes):
    """3001 source and 2999 target points: both pad to a multiple of 8."""
    pts = dental_arch_cloud(3001, seed=4)
    T_true = _rigid(5, angle=0.05, trans=0.05)
    tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3])[:2999].astype(np.float32)
    rj, rp = _both(meshes, pts, tgt, tgt_normals=_target_normals(tgt), dist_thresh=0.4,
                   max_iterations=30)
    np.testing.assert_allclose(_close(rj, rp), T_true, atol=5e-3)


def test_block_sparse_ring_matches_jax_and_dense(meshes):
    pts = dental_arch_cloud(12_000, seed=0)
    T_true = _rigid(1, angle=0.05, trans=0.05)
    tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    down = estimate_normals(voxel_downsample_host(tgt, 0.3), 0.6)
    _, idx = j_nn_search(jnp.asarray(tgt), down.points, None, down.mask)
    nrm = np.asarray(down.normals)[np.asarray(idx)]
    kw = dict(tgt_normals=nrm, dist_thresh=0.3, max_iterations=5)
    rj, rp = _both(meshes, pts, tgt, block_sparse=True, block=256, w=8, **kw)
    Tp = _close(rj, rp)
    dense = icp_refine_sharded(meshes[1], pts, tgt, np.eye(4), **kw)
    np.testing.assert_allclose(Tp, dense.transformation.numpy(), atol=2e-3)
    np.testing.assert_allclose(Tp, T_true, atol=2e-3)
    assert float(rp.fitness) > 0.99


@pytest.mark.parametrize("case", ["no_overlap", "tiny", "coplanar", "positive_octant"])
def test_degenerate_clouds_match_jax(meshes, case):
    """tests/test_sharded_icp.py's degenerate cases: finite everywhere."""
    if case == "no_overlap":
        src = dental_arch_cloud(2000, seed=0)
        tgt, iters = src + 1000.0, 5
    elif case == "tiny":
        src = tgt = dental_arch_cloud(5, seed=1)
        iters = 3
    elif case == "coplanar":
        rng = np.random.default_rng(2)
        src = np.zeros((1000, 3), np.float32)
        src[:, :2] = rng.uniform(-1, 1, (1000, 2))
        tgt, iters = src, 5
    else:
        src = dental_arch_cloud(2001, seed=0) + 3.0
        rng = np.random.default_rng(0)
        tgt, iters = (src + 0.005 * rng.standard_normal(src.shape)).astype(np.float32), 5
    rj, rp = _both(meshes, src, tgt, dist_thresh=0.3, max_iterations=iters,
                   point_to_plane=False)
    Tp = _close(rj, rp)
    if case == "no_overlap":
        assert float(rp.fitness) == 0.0
    elif case == "tiny":
        np.testing.assert_allclose(Tp, np.eye(4), atol=1e-4)
    elif case == "positive_octant":
        np.testing.assert_allclose(Tp, np.eye(4), atol=5e-3)
    if case != "no_overlap":
        assert float(rp.fitness) > 0.99 or case == "coplanar"


def _jax_restart_bits(key, restarts, n_chunks, k):
    """coarse_pose_with_verification's schedule (tests/test_torch_large.py):
    restart r folds r into the key, global_registration_two_mode splits off
    the correspondence key, and each chunk splits its sample key."""
    out = []
    for r in range(restarts):
        _, key_r = jax.random.split(jax.random.fold_in(key, r))
        rows = []
        for _ in range(n_chunks):
            key_r, k_samp = jax.random.split(key_r)
            rows.append(np.asarray(jax.random.bits(k_samp, (k, 2), jnp.uint32)))
        out.append(np.stack(rows))
    return torch.from_numpy(np.stack(out).astype(np.int64))


def test_register_arrays_large_with_mesh_matches_jax(meshes):
    """20,000 points, JAX's coarse bits, then 3 full-resolution ICP
    iterations on the dense ring (the mesh default; the block-sparse ring is
    held to JAX's above): the refined poses agree, and both pass the large
    gate.  The iteration cap keeps the port's plain searches (8 x 8 dense
    2500 x 2500 steps an iteration on one CPU thread) short."""
    sp, tp, T_true = make_benchmark_pair(20_000, seed=3, sigma=0.005)
    jcfg = dataclasses.replace(JCFG, icp=dataclasses.replace(JCFG.icp, max_iterations=3))
    pcfg = dataclasses.replace(PCFG, icp=dataclasses.replace(PCFG.icp, max_iterations=3))
    jm, pm = meshes
    fj, _ = jlarge.register_arrays_large(sp, tp, jcfg, mesh=jm)
    rc = JCFG.ransac
    bits = _jax_restart_bits(jax.random.PRNGKey(0), 4,
                             pransac.chunk_count(rc.max_iterations, rc.batch_size), rc.batch_size)
    fp, _ = plarge.register_arrays_large(sp, tp, pcfg, device="cpu", sample_bits=bits, mesh=pm)
    Tj, Tp = np.asarray(fj.transformation), fp.transformation.numpy()
    assert _rot_err_deg(Tp, Tj) < 0.1
    assert np.abs(Tp[:3, 3] - Tj[:3, 3]).max() < 5e-3
    for T in (Tj, Tp):
        T = T.astype(np.float64)
        moved = sp @ T[:3, :3].T + T[:3, 3]
        expect = sp @ T_true[:3, :3].T + T_true[:3, 3]
        assert _rot_err_deg(T, T_true) < 2.0
        assert np.sqrt(((moved - expect) ** 2).sum(1).mean()) < 0.01
    assert float(fp.fitness) > 0.95
