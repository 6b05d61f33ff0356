"""Port parity for the stream's escalation (CPU, small shapes): the SO(3)
and SE(3) logs, ``verify_elect_probes`` and ``escalated_register_step``
against the JAX functions vmapped over 2-3 lanes.

The escalation's RANSAC samples every valid row (m_s = M) and extends its
budget adaptively; the port takes JAX's bits for both, rebuilt as in
tests/test_torch_ransac_options.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core import se3 as jse3
from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.preprocess.pipeline import preprocess_points
from tpu3dm.registration import fused as jfused
from tpu3dm_torch.core import se3 as pse3
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.parallel.multipair import extra_chunk_count
from tpu3dm_torch.registration import fused as pfused
from test_torch_ransac_options import jax_chunk_bits, jax_extra_bits

CFG = PipelineConfig.with_voxel_size(0.3)
K = 512
N_MODES = 3  # 1 + 3 + 3 x 5 = 19 probes a lane with init_T


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rotations(rng, angles):
    axes = rng.normal(size=(len(angles), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return (axes * np.asarray(angles)[:, None]).astype(np.float32)


@pytest.mark.parametrize("regime", ["random", "near_identity", "near_pi"])
def test_log_so3_and_log_se3_match_jax(regime):
    """log_so3 / log_se3 of exp'd twists, in each of JAX's branches: the
    generic formula, the series below 1e-4 rad and the symmetric-part axis
    within 1e-3 of pi (plus both sides of each switch)."""
    rng = np.random.default_rng({"random": 0, "near_identity": 1, "near_pi": 2}[regime])
    angles = {
        "random": rng.uniform(0.0, np.pi - 0.01, 64),
        "near_identity": np.concatenate([[0.0, 1e-7, 1e-6, 5e-5, 9.9e-5, 1.01e-4, 3e-4],
                                         rng.uniform(0, 1e-4, 25)]),
        "near_pi": np.concatenate([np.pi - np.float64([0.0, 1e-5, 1e-4, 5e-4, 9e-4, 1.2e-3,
                                                        3e-3]),
                                   np.pi - rng.uniform(0, 1e-3, 25)]),
    }[regime]
    w = _rotations(rng, angles)
    R = np.array(jse3.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(pse3.log_so3(torch.from_numpy(R)).numpy(),
                               np.asarray(jse3.log_so3(jnp.asarray(R))), atol=1e-5)
    xi = np.concatenate([rng.normal(size=w.shape).astype(np.float32) * 3, w], axis=1)
    T = np.array(jse3.exp_se3(jnp.asarray(xi)))
    got = pse3.log_se3(torch.from_numpy(T)).numpy()
    want = np.asarray(jse3.log_se3(jnp.asarray(T)))
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=1e-5)
    # rho = V^-1 t: an error e in w moves it by ~ e |t| (|t| up to ~10
    # here), and just above theta^2 = 1e-8 JAX's coefficient (1 - A / 2B) /
    # theta^2 cancels to large values in both packages alike, so rho is held
    # to 1e-5 (1 + |t|) and to 2e-5 of its size.
    t_size = np.linalg.norm(T[:, :3, 3], axis=1, keepdims=True)
    assert (np.abs(got[:, :3] - want[:, :3])
            <= 1e-5 * (1 + t_size) + 2e-5 * np.abs(want[:, :3])).all()


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


def _rot_apart_deg(Ta, Tb):
    fro = np.linalg.norm(Ta[..., :3, :3].astype(np.float64) - Tb[..., :3, :3], axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))


def _assert_close(outj, outp, T_true=None, fit_atol=1e-6, src=None):
    """Rotation within 0.05 deg, translation within 5e-3 (with ``src``
    [M, 3]: the RMS gap between the source points each pose moves, which a
    far-origin pose's translation would overstate), fitness within fit_atol
    and rmse within 1e-4 of JAX's; with T_true, every lane of both within
    2 deg of it."""
    (Tj, fj, rj), (Tp, fp, rp) = ([np.asarray(x) for x in o] for o in (outj, outp))
    assert _rot_apart_deg(Tp, Tj).max() < 0.05
    if src is None:
        assert np.abs(Tp[:, :3, 3] - Tj[:, :3, 3]).max() < 5e-3
    else:
        s64 = src.astype(np.float64)
        gap = [np.sqrt(np.mean(np.sum((s64 @ (a[:3, :3] - b[:3, :3]).T + (a[:3, 3] - b[:3, 3]))
                                      ** 2, axis=1))) for a, b in zip(Tp.astype(np.float64), Tj)]
        assert max(gap) < 5e-3
    np.testing.assert_allclose(fp, fj, atol=fit_atol)
    np.testing.assert_allclose(rp, rj, atol=1e-4)
    if T_true is not None:
        for T in (Tj, Tp):
            assert _rot_apart_deg(T, T_true[None]).max() < 2.0


def _perturbed(T_true, rng, n, scale):
    xi = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    return np.asarray(jse3.exp_se3(jnp.asarray(xi))) @ T_true.astype(np.float32)


@pytest.mark.parametrize("nn_impl", ["values_pk", "lane"])
def test_verify_elect_probes_matches_jax(arch_pair, nn_impl):
    """Explicit probes (near the truth, one far), 2 lanes x 6 probes: the
    snap, the annealed solves, the lexicographic election and the fine
    polish, with the f16 payload (values_pk) and without (lane)."""
    sd, td, pcs, pct, _, T_true = arch_pair
    rng = np.random.default_rng(3)
    cands = np.stack([_perturbed(T_true, rng, 6, s) for s in (0.02, 0.05)])
    cands[:, -1] = _perturbed(T_true, rng, 1, 0.6)[0]
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, icp_thresh=CFG.icp.dist_thresh,
              verify_iters=8, nn_impl=nn_impl)
    outj = jax.vmap(lambda c: jfused.verify_elect_probes(
        sd.points, sd.mask, td.points, td.mask, td.normals, c, **kw))(jnp.asarray(cands))

    def rep(x):
        return x[None].expand(2, *x.shape)

    outp = pfused.verify_elect_probes(rep(pcs.points), rep(pcs.mask), rep(pct.points),
                                      rep(pct.mask), rep(pct.normals), torch.from_numpy(cands),
                                      **kw)
    _assert_close(outj, outp, T_true)


def test_screw_probes_match_jax_lattice():
    """The probe lattice: init_T, the modes, then exp(t log(Tj inv(Ti))) Ti."""
    rng = np.random.default_rng(4)
    Ts = np.array(jse3.exp_se3(jnp.asarray(rng.normal(size=(2, 4, 6)).astype(np.float32))))
    init = np.array(jse3.exp_se3(jnp.asarray(rng.normal(size=(2, 6)).astype(np.float32))))
    got = pfused.screw_probes(torch.from_numpy(Ts), torch.from_numpy(init)).numpy()
    assert got.shape == (2, 1 + 4 + 6 * 5, 4, 4)
    for b in range(2):
        want = [init[b]] + list(Ts[b])
        for i in range(4):
            for j in range(i + 1, 4):
                xi = jse3.log_se3(jnp.asarray(Ts[b, j] @ np.asarray(jse3.inverse(Ts[b, i]))))
                want += [np.asarray(jse3.exp_se3(t * xi)) @ Ts[b, i] for t in pfused.SCREW_POWERS]
        np.testing.assert_allclose(got[b], np.stack(want), atol=2e-5)


@pytest.mark.parametrize("with_init", [False, True])
def test_escalated_register_step_matches_jax(arch_pair, with_init):
    """The whole escalation at N_MODES modes, 512 + up to 512 adaptive
    hypotheses (every valid row sampled), with and without the caller's
    pose (a world pose, moved 1000 units from the origin with both clouds,
    so the frame shift conjugates it)."""
    sd, td, pcs, pct, _, T_true = arch_pair
    shift = np.float32([1000.0, -2000.0, 1500.0])
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    init = None
    if with_init:
        rng = np.random.default_rng(5)
        init = _perturbed(T_true, rng, 2, 0.01)
        init[:, :3, 3] += shift - init[:, :3, :3] @ shift
    kw = dict(dist_thresh=CFG.ransac.dist_thresh, icp_thresh=CFG.icp.dist_thresh,
              ransac_iterations=K, ransac_batch=K, n_modes=N_MODES, adapt_iterations=2 * K,
              verify_iters=8)
    args_j = (sd.points + shift, sd.features, sd.mask, td.points + shift, td.features, td.mask,
              td.normals)
    if init is None:
        outj = jax.vmap(lambda k: jfused.escalated_register_step(*args_j, k, **kw))(keys)
    else:
        outj = jax.vmap(lambda k, t: jfused.escalated_register_step(*args_j, k, t, **kw))(
            keys, jnp.asarray(init))
    m = sd.capacity
    bits = torch.from_numpy(np.stack([jax_chunk_bits(k, 1, (m,)) for k in keys]))
    extra = torch.from_numpy(np.stack([jax_extra_bits(k, extra_chunk_count(K, 2 * K, K), (m,))
                                       for k in keys]))

    def rep(x):
        return x[None].expand(2, *x.shape)

    sh = torch.from_numpy(shift)
    outp = pfused.escalated_register_step(
        rep(pcs.points + sh), rep(pcs.features), rep(pcs.mask), rep(pct.points + sh),
        rep(pct.features), rep(pct.mask), rep(pct.normals), bits,
        None if init is None else torch.from_numpy(init), extra_bits=extra, device="cpu", **kw)
    T_world = T_true.copy()
    T_world[:3, 3] += shift - T_true[:3, :3] @ shift
    src = np.asarray(sd.points)[np.asarray(sd.mask)] + shift
    _assert_close(outj, outp, T_world, src=src)
