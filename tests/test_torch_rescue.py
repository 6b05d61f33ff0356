"""Port parity for the fused step's non-mutual route and batched alias
rescue (CPU, small shapes).

The same JAX-preprocessed arch pair goes through the JAX functions (vmapped
over keys, ``nn_impl="lane"``) and their ports.  RANSAC samples are shared
by rebuilding JAX's bits along its key schedule and handing them to the
port: ``split(key, R)`` per lane for the rescue's restarts, ``split(k,
n_chunks)`` per restart, ``jax.random.bits(k_chunk, (m_s,))`` per chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops.nn import nn_mutual_mask
from tpu3dm.parallel.multipair import ransac_pair_step as j_ransac
from tpu3dm.preprocess.pipeline import preprocess_points
from tpu3dm.registration import fused as jfused
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.parallel.multipair import ransac_pair_step as p_ransac
from tpu3dm_torch.registration import fused as pfused
from tpu3dm_torch.registration.hypotheses import sample_row_count

CFG = PipelineConfig.with_voxel_size(0.3)
K = 512  # hypotheses a chunk: keeps the JAX compile short


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rot_err_deg(Ta, Tb):
    M = Ta[..., :3, :3] @ np.swapaxes(Tb[..., :3, :3], -1, -2)
    return np.degrees(np.arccos(np.clip((np.trace(M, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


def _rot_apart_deg(Ta, Tb):
    """Angle between the rotations of Ta and Tb in float64, from
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): exact near 0, where arccos of
    the float32 trace is not (it rounds 2e-5 deg up to 0.05)."""
    fro = np.linalg.norm(Ta[..., :3, :3].astype(np.float64) - Tb[..., :3, :3], axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))


def _chunk_bits(key, m_s, n_chunks):
    """[n_chunks, m_s]: the bits JAX's ransac_pair_step draws from ``key``."""
    return np.stack([np.asarray(jax.random.bits(kc, (m_s,), jnp.uint32))
                     for kc in jax.random.split(key, n_chunks)]).astype(np.int64)


def _rescue_bits(keys, restarts, m_s, n_chunks=1):
    """[B, R, n_chunks, m_s]: the rescue's restart r of lane b draws from
    split(keys[b], R)[r]."""
    return torch.from_numpy(np.stack([
        np.stack([_chunk_bits(kr, m_s, n_chunks) for kr in jax.random.split(k, restarts)])
        for k in keys
    ]))


@pytest.fixture(scope="module")
def arch_pair():
    """The bench's arch pair (20k points, seed 0), preprocessed by JAX, plus
    the same clouds carried across to the port."""
    sp, tp, T_true = make_benchmark_pair(20000, seed=0, sigma=0.01)
    src = preprocess_points(sp, CFG.preprocess).down
    tgt = preprocess_points(tp, CFG.preprocess).down

    def arrays(pc):
        return {f: np.asarray(getattr(pc, f)) for f in ("points", "normals", "features", "mask")}

    return (src, tgt, from_reference_arrays(arrays(src), device="cpu"),
            from_reference_arrays(arrays(tgt), device="cpu"), sp, T_true)


def _gate(T, T_true, src_pts):
    """bench.py's per-lane gate: rotation error and closed-form alignment RMSE."""
    rot = _rot_err_deg(T, T_true)
    mu, M2 = src_pts.mean(0), src_pts.T @ src_pts / src_pts.shape[0]
    A = T[:, :3, :3] - T_true[:3, :3]
    b = T[:, :3, 3] - T_true[:3, 3]
    rmse2 = (np.einsum("bij,jk,bik->b", A, M2, A) + 2 * np.einsum("bi,bij,j->b", b, A, mu)
             + (b * b).sum(1))
    return rot, np.sqrt(np.maximum(rmse2, 0))


# ---------------------------------------------------------------------------
# Two-mode and N-mode RANSAC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_modes", [2, 6])
def test_ransac_pair_step_two_mode_matches_jax(arch_pair, n_modes):
    """Same correspondences, same bits, two chunks (so modes merge across
    chunks): counts equal in every mode.  Ts within 1e-4 where a mode has
    at least 50 inliers; within 1e-3 for the weaker modes, whose fp32 Horn
    refit on a few dozen spread inliers moves with the summation order
    (measured: a 34-inlier mode 3.8e-4 and 0.013 deg apart)."""
    sd, td, _, _, _, _ = arch_pair
    idx, mutual = nn_mutual_mask(sd.features, td.features, sd.mask, td.mask)
    p_all, q_all, valid = sd.points, td.points[idx], sd.mask & mutual
    B, n_chunks = 3, 2
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, iterations=n_chunks * K, batch_size=K,
              approx_score=True, two_mode=True, n_modes=n_modes)
    Tj, cj = jax.vmap(lambda k: j_ransac(p_all, q_all, valid, k, **kw))(keys)
    bits = np.stack([_chunk_bits(k, sample_row_count(p_all.shape[0], K), n_chunks) for k in keys])
    rep = [torch.from_numpy(np.array(x))[None].expand(B, *x.shape) for x in (p_all, q_all, valid)]
    Tp, cp = p_ransac(*rep, torch.from_numpy(bits), **kw)
    assert Tp.shape == (B, n_modes, 4, 4) and cp.shape == (B, n_modes)
    cj, Tj = np.asarray(cj), np.asarray(Tj)
    np.testing.assert_array_equal(cp.numpy(), cj)
    strong = cj >= 50
    np.testing.assert_allclose(Tp.numpy()[strong], Tj[strong], atol=1e-4)
    np.testing.assert_allclose(Tp.numpy(), Tj, atol=1e-3)
    assert (cj[:, 0] > 50).all() and (cj[:, 1:] > 0).all()


# ---------------------------------------------------------------------------
# The fused step: non-mutual correspondences, and the rescue
# ---------------------------------------------------------------------------


def _run_both(arch_pair, keys, **opts):
    """JAX fused step (nn_impl='lane', vmapped over keys) and the port with
    the same bits."""
    sd, td, pcs, pct, _, _ = arch_pair
    B = len(keys)
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, icp_thresh=CFG.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, icp_iterations=4, icp_solves_per_nn=4,
              approx_score=True, **opts)
    outj = jax.vmap(lambda k: jfused.fused_register_step(
        sd.points, sd.features, sd.mask, sd.normals, td.points, td.features, td.mask,
        td.normals, k, approx_features=False, nn_impl="lane", **kw))(keys)
    m_s = sample_row_count(sd.capacity, K)
    restarts = opts.get("rescue_restarts", 0)
    if restarts:
        bits = _rescue_bits(keys, restarts, m_s)
    else:
        bits = torch.from_numpy(np.stack([_chunk_bits(k, m_s, 1) for k in keys]))

    def rep(x):
        return x[None].expand(B, *x.shape)

    outp = pfused.fused_register_step(
        rep(pcs.points), rep(pcs.features), rep(pcs.mask), rep(pcs.normals),
        rep(pct.points), rep(pct.features), rep(pct.mask), rep(pct.normals),
        bits, device="cpu", nn_impl="lane", **kw)
    return [np.asarray(x) for x in outj], [x.numpy() for x in outp]


def _assert_parity(arch_pair, outj, outp):
    """Rotation within 0.05 deg and translation within 5e-3 of JAX's, the
    RANSAC fitness equal to 1e-6 (the same counts over the same valid
    rows), and both inside the bench gate (2 deg, RMSE 0.1) against T_true."""
    (Tj, fj, _), (Tp, fp, _) = outj, outp
    _, _, _, _, sp, T_true = arch_pair
    assert _rot_apart_deg(Tp, Tj).max() < 0.05
    assert np.abs(Tp[:, :3, 3] - Tj[:, :3, 3]).max() < 5e-3
    np.testing.assert_allclose(fp, fj, atol=1e-6)
    for T in (Tj, Tp):
        rot, rmse = _gate(T.astype(np.float64), T_true, sp)
        assert rot.max() < 2.0 and rmse.max() < 0.1


def test_fused_register_step_non_mutual_matches_jax(arch_pair):
    """mutual_filter=False: every source row's forward 33-D NN (kernel 7's
    route) feeds the RANSAC."""
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    outj, outp = _run_both(arch_pair, keys, mutual_filter=False)
    _assert_parity(arch_pair, outj, outp)


@pytest.mark.parametrize("mutual", [True, False])
def test_fused_register_step_rescue_matches_jax(arch_pair, mutual):
    """rescue_restarts=2, rescue_modes=6, verify_iters=8: 12 candidates a
    lane, deduplicated to at most 10, each verified by annealed ICP, then
    elected; the same bits in both packages."""
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    outj, outp = _run_both(arch_pair, keys, mutual_filter=mutual, rescue_restarts=2,
                           rescue_modes=6, verify_iters=8)
    _assert_parity(arch_pair, outj, outp)


def test_rescue_checks_bits_shape(arch_pair):
    _, _, pcs, pct, _, _ = arch_pair
    args = [x[None] for c in (pcs, pct) for x in (c.points, c.features, c.mask, c.normals)]
    bits = torch.zeros(1, 1, sample_row_count(pcs.capacity, K), dtype=torch.int64)
    with pytest.raises(ValueError):
        pfused.fused_register_step(*args, bits, device="cpu", ransac_iterations=K,
                                   ransac_batch=K, rescue_restarts=2)
