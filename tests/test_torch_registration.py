"""Port parity for tpu3dm_torch's registration path (CPU, small shapes).

Each test sends the same numpy inputs through the JAX function and its port.
RANSAC samples are shared by rebuilding the JAX sample bits
(``jax.random.bits`` of ``split(key, n_chunks)``) and handing them to the
port, so both packages draw the same triples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core import se3 as jse3
from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.ops.compact import compaction_permutation as j_compact
from tpu3dm.ops.sym4 import dominant_eigvec_sym4 as j_sym4
from tpu3dm.parallel.multipair import ransac_pair_step as j_ransac
from tpu3dm.preprocess.pipeline import preprocess_points
from tpu3dm.registration import fused as jfused
from tpu3dm.registration import hypotheses as jhyp
from tpu3dm.registration.kabsch import fit_rigid_horn as j_horn
from tpu3dm_torch.core import se3 as pse3
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.ops.compact import compaction_permutation as p_compact
from tpu3dm_torch.ops.sym4 import dominant_eigvec_sym4 as p_sym4
from tpu3dm_torch.parallel.multipair import ransac_pair_step as p_ransac
from tpu3dm_torch.registration import fused as pfused
from tpu3dm_torch.registration import hypotheses as phyp
from tpu3dm_torch.registration.kabsch import fit_rigid_horn as p_horn

CFG = PipelineConfig.with_voxel_size(0.3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot_err_deg(Ta, Tb):
    M = Ta[..., :3, :3] @ np.swapaxes(Tb[..., :3, :3], -1, -2)
    tr = np.clip((np.trace(M, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(tr))


def _jax_bits(keys, m_s, n_chunks=1):
    """The uint32 sample bits JAX's ransac_pair_step draws from each key."""
    return np.stack([
        np.stack([np.asarray(jax.random.bits(kc, (m_s,), jnp.uint32))
                  for kc in jax.random.split(k, n_chunks)])
        for k in keys
    ]).astype(np.int64)


# ---------------------------------------------------------------------------
# Small pieces (fp32 tolerances: 1e-5 relative to O(1) values)
# ---------------------------------------------------------------------------


def test_exp_se3_and_apply_match_jax():
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(64, 6)) * 0.5).astype(np.float32)
    xi[:8, 3:] *= 1e-6  # the small-angle series branch
    pts = rng.normal(size=(64, 20, 3)).astype(np.float32)
    Tj = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    Tp = pse3.exp_se3(_t(xi))
    np.testing.assert_allclose(Tp.numpy(), Tj, atol=1e-5)
    np.testing.assert_allclose(pse3.exp_so3(_t(xi[:, 3:])).numpy(),
                               np.asarray(jse3.exp_so3(jnp.asarray(xi[:, 3:]))), atol=1e-5)
    np.testing.assert_allclose(pse3.apply(Tp, _t(pts)).numpy(),
                               np.asarray(jse3.apply(jnp.asarray(Tj), jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_allclose(pse3.inverse(Tp).numpy(), np.asarray(jse3.inverse(jnp.asarray(Tj))),
                               atol=1e-5)
    np.testing.assert_allclose(pse3.hat(_t(xi[:, 3:])).numpy(),
                               np.asarray(jse3.hat(jnp.asarray(xi[:, 3:]))))


def test_fit3_frames_matches_jax():
    rng = np.random.default_rng(1)
    pa, pb, pc = (rng.normal(size=(256, 3)).astype(np.float32) for _ in range(3))
    qa, qb, qc = (rng.normal(size=(256, 3)).astype(np.float32) for _ in range(3))
    pb[:4] = pa[:4]  # degenerate samples
    Rj, tj, okj = jhyp.fit3_frames(*(jnp.asarray(x) for x in (pa, pb, pc, qa, qb, qc)))
    Rp, tp, okp = phyp.fit3_frames(*(_t(x) for x in (pa, pb, pc, qa, qb, qc)))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert not okp[:4].any()
    ok = np.asarray(okj)
    for i in range(3):
        np.testing.assert_allclose(tp[i].numpy()[ok], np.asarray(tj[i])[ok], atol=1e-5)
        for j in range(3):
            np.testing.assert_allclose(Rp[i][j].numpy()[ok], np.asarray(Rj[i][j])[ok], atol=1e-5)


def test_sym4_and_horn_match_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(128, 4, 4)).astype(np.float32)
    N = A + np.swapaxes(A, 1, 2)
    N -= np.eye(4, dtype=np.float32) * (np.trace(N, axis1=1, axis2=2) / 4)[:, None, None]
    vj = np.asarray(j_sym4(jnp.asarray(N)))
    vp = p_sym4(_t(N)).numpy()
    np.testing.assert_allclose(vp, vj, atol=1e-4)

    p = rng.normal(size=(16, 50, 3)).astype(np.float32)
    Ttrue = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))))
    q = p @ np.swapaxes(Ttrue[:, :3, :3], 1, 2) + Ttrue[:, None, :3, 3]
    q += rng.normal(size=q.shape).astype(np.float32) * 0.01
    w = (rng.random((16, 50)) > 0.3).astype(np.float32)
    Tj = np.asarray(j_horn(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w)))
    Tp = p_horn(_t(p), _t(q), _t(w)).numpy()
    np.testing.assert_allclose(Tp, Tj, atol=1e-5)
    assert _rot_err_deg(Tp, Ttrue).max() < 2.0


def test_compaction_permutation_matches_jax():
    rng = np.random.default_rng(3)
    valid = rng.random((4, 301)) > 0.4
    pj = np.stack([np.asarray(j_compact(jnp.asarray(v))) for v in valid])
    np.testing.assert_array_equal(p_compact(_t(valid)).numpy(), pj)


def test_p2pl_delta_planar_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(3, 400, 3)).astype(np.float32)
    q = (pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32)
    n = rng.normal(size=pts.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = (rng.random((3, 400)) > 0.2).astype(np.float32)
    xj = np.stack([np.asarray(jfused._p2pl_delta_planar(*(jnp.asarray(x[b]) for x in (pts, q, n, w))))
                   for b in range(3)])
    xp = pfused._p2pl_delta_planar(_t(pts), _t(q), _t(n), _t(w)).numpy()
    np.testing.assert_allclose(xp, xj, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# RANSAC and the fused step on the JAX-preprocessed benchmark pair
# ---------------------------------------------------------------------------


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


def test_ransac_pair_step_matches_jax(arch_pair):
    """Same correspondences, same sample bits: counts and winners equal,
    T within 1e-4."""
    from tpu3dm.ops.nn import nn_mutual_mask

    sd, td, _, _, _, _ = arch_pair
    idx, mutual = nn_mutual_mask(sd.features, td.features, sd.mask, td.mask)
    p_all, q_all, valid = sd.points, td.points[idx], sd.mask & mutual
    K, B = 512, 3
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    bits = _jax_bits(keys, phyp.sample_row_count(p_all.shape[0], K))
    for approx in (False, True):
        Tj, cj = jax.vmap(lambda k: j_ransac(
            p_all, q_all, valid, k, dist_thresh=CFG.ransac.dist_thresh, iterations=K,
            batch_size=K, approx_score=approx))(keys)
        rep = [torch.from_numpy(np.array(x))[None].expand(B, *x.shape) for x in (p_all, q_all, valid)]
        Tp, cp = p_ransac(*rep, torch.from_numpy(bits), dist_thresh=CFG.ransac.dist_thresh,
                          iterations=K, batch_size=K, approx_score=approx)
        np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
        np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-4)
        assert (cp.numpy() > 50).all()


@pytest.mark.parametrize("case", ["roll_bits", "gather_bits", "extra_bits", "sample_mode"])
def test_ransac_pair_step_rejects_unported_modes(case):
    """Every mode of the JAX step is ported (two-stage scoring, the adaptive
    budget and the gather sampler: tests/test_torch_ransac_options.py); what
    the step still rejects is bits of the wrong shape for its sampler, and
    an unknown sampler."""
    z = torch.zeros(1, 16, 3)
    v = torch.ones(1, 16, dtype=torch.bool)
    bad = {
        "roll_bits": dict(sample_bits=torch.zeros(1, 1, 15, dtype=torch.int64)),
        "gather_bits": dict(sample_bits=torch.zeros(1, 1, 16, dtype=torch.int64),
                            sample_mode="gather"),
        "extra_bits": dict(adapt_iterations=64,
                           extra_bits=torch.zeros(1, 2, 16, dtype=torch.int64)),
        "sample_mode": dict(sample_mode="triples"),
    }[case]
    with pytest.raises(ValueError):
        p_ransac(z, z + 0.1, v, dist_thresh=0.45, iterations=16, batch_size=16, **bad)


def _run_both(sd, td, pcs, pct, keys, *, K, approx, shift=None):
    """JAX fused step (nn_impl='lane', vmapped over keys) and the port with
    the same bits; ``shift`` moves both clouds' points."""
    B = len(keys)
    sp_, tp_ = sd.points, td.points
    if shift is not None:
        sp_, tp_ = sp_ + jnp.asarray(shift), tp_ + jnp.asarray(shift)
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, icp_thresh=CFG.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, icp_iterations=4, icp_solves_per_nn=4,
              approx_score=approx)
    outj = jax.vmap(lambda k: jfused.fused_register_step(
        sp_, sd.features, sd.mask, sd.normals, tp_, td.features, td.mask, td.normals, k,
        approx_features=False, nn_impl="lane", **kw))(keys)
    bits = _jax_bits(keys, phyp.sample_row_count(sd.capacity, K))

    def rep(x):
        return x[None].expand(B, *x.shape)

    ps, pt = pcs.points, pct.points
    if shift is not None:
        ps, pt = ps + _t(shift), pt + _t(shift)
    outp = pfused.fused_register_step(
        rep(ps), rep(pcs.features), rep(pcs.mask), rep(pcs.normals),
        rep(pt), rep(pct.features), rep(pct.mask), rep(pct.normals),
        torch.from_numpy(bits), device="cpu", nn_impl="lane", **kw)
    return [np.asarray(x) for x in outj], [x.numpy() for x in outp]


def _gate(T, T_true, src_pts):
    """bench.py's per-lane gate: rotation error and closed-form alignment RMSE."""
    rot = _rot_err_deg(T, T_true)
    mu, M2 = src_pts.mean(0), src_pts.T @ src_pts / src_pts.shape[0]
    A = T[:, :3, :3] - T_true[:3, :3]
    b = T[:, :3, 3] - T_true[:3, 3]
    rmse2 = (np.einsum("bij,jk,bik->b", A, M2, A) + 2 * np.einsum("bi,bij,j->b", b, A, mu)
             + (b * b).sum(1))
    return rot, np.sqrt(np.maximum(rmse2, 0))


@pytest.mark.parametrize("approx", [False, True])
def test_fused_register_step_matches_jax(arch_pair, approx):
    """Whole slice: rotation within 0.05 deg and translation within 5e-3 of
    JAX's, both inside the bench gate (2 deg, RMSE 0.1) against T_true."""
    sd, td, pcs, pct, sp, T_true = arch_pair
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    (Tj, fj, rj), (Tp, fp, rp) = _run_both(sd, td, pcs, pct, keys, K=512, approx=approx)
    assert _rot_err_deg(Tp, Tj).max() < 0.05
    assert np.abs(Tp[:, :3, 3] - Tj[:, :3, 3]).max() < 5e-3
    np.testing.assert_allclose(fp, fj, atol=1e-6)
    np.testing.assert_allclose(rp, rj, atol=1e-4)
    for T in (Tj, Tp):
        rot, rmse = _gate(T.astype(np.float64), T_true, sp)
        assert rot.max() < 2.0 and rmse.max() < 0.1


def test_fused_register_step_position_invariant(arch_pair):
    """A pair 1000-2000 units from the origin registers like the same pair at
    the origin (the frame shift conjugates the pose exactly)."""
    sd, td, pcs, pct, sp, T_true = arch_pair
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    shift = np.array([1000.0, -2000.0, 1500.0], np.float32)
    (_, _, _), (T0, f0, _) = _run_both(sd, td, pcs, pct, keys, K=512, approx=True)
    (Tjs, _, _), (Ts, fs, _) = _run_both(sd, td, pcs, pct, keys, K=512, approx=True, shift=shift)
    T_shift = T_true.copy()
    T_shift[:3, 3] = T_true[:3, 3] + shift - T_true[:3, :3] @ shift
    rot, rmse = _gate(Ts.astype(np.float64), T_shift, sp + shift)
    assert rot.max() < 1.0 and rmse.max() < 0.05
    assert _rot_err_deg(Ts, T0).max() < 0.2
    assert _rot_err_deg(Ts, Tjs).max() < 0.05
    np.testing.assert_allclose(fs, f0, atol=0.02)


@pytest.mark.parametrize("case", ["gather_bits", "rescue_extra_bits", "rescue_sample_bits",
                                  "mesh"])
def test_fused_register_step_rejects_unported_options(case):
    """Every nn_impl and RANSAC option of the JAX step is ported
    (tests/test_torch_values_route.py, test_torch_rescue.py); the step
    rejects bits of the wrong shape for its sampler, for the rescue's
    restarts (no restart axis) or for their extra chunks, and the large
    path a mesh that is not a parallel.mesh.Mesh."""
    z3 = np.zeros((1, 16, 3), np.float32)
    f = np.zeros((1, 16, 33), np.float32)
    m = np.ones((1, 16), bool)
    args = (z3, f, m, z3, z3, f, m, z3)
    kw = dict(ransac_iterations=16, ransac_batch=16, device="cpu")
    if case == "gather_bits":
        with pytest.raises(ValueError):
            pfused.fused_register_step(*args, torch.zeros(1, 1, 16, dtype=torch.int64),
                                       sample_mode="gather", **kw)
    elif case == "rescue_extra_bits":
        with pytest.raises(ValueError):
            pfused.fused_register_step(*args, rescue_restarts=2, adapt_iterations=64,
                                       extra_bits=torch.zeros(1, 3, 16, dtype=torch.int64), **kw)
    elif case == "rescue_sample_bits":
        with pytest.raises(ValueError):
            pfused.fused_register_step(*args, torch.zeros(1, 1, 16, dtype=torch.int64),
                                       rescue_restarts=2, **kw)
    else:
        from tpu3dm_torch.registration.large import register_arrays_large

        pts = np.zeros((64, 3), np.float32)
        with pytest.raises(TypeError, match="Mesh"):
            register_arrays_large(pts, pts, mesh=object(), device="cpu")
