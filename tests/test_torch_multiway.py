"""Port parity for tpu3dm_torch's multi-way registration
(multiway/posegraph.py) and the out-of-place SE(3) assembly it needs, on
the CPU at small shapes.

Tolerances:
  - the new ``make`` / ``inverse`` / ``exp_se3`` equal the old in-place
    forms (kept below as the reference) bit for bit; ``torch.func.jacfwd``
    through them within 1e-5 of ``jax.jacfwd``;
  - pose-graph solves (dense and edgewise) within 1e-4 of JAX's poses on
    the same graphs (both run the same fp32 Gauss-Newton; the solves'
    rounding differs, ~2e-5 seen), and the exact chain within 1e-3 of the
    truth, as JAX's own test.  The robust solve within 1e-2 of JAX and
    0.02 of the truth: with the Geman-McClure weights re-fitted every step,
    JAX's own poses move by up to ~5e-3 from one iteration count to the
    next (fp32 arccos in log_so3 near identity feeds its rounding into the
    Jacobian), and the port's by as much;
  - the registrations: each edge within the fused-step / pipeline bounds of
    tests/test_torch_batch.py and tests/test_torch_pipeline.py (rotation <
    0.05 deg, translation < 5e-3, fitness within 1e-6 for RANSAC and 1e-3
    for ICP); the solved poses within 1e-4 of JAX's solve on the port's
    own edges, and within 0.2 deg / 0.01 of JAX's whole run: near-consistent
    views leave residuals near identity, where the fp32 arccos of the solve
    turns edges 1e-5 deg apart into poses ~0.07 deg apart (JAX's solve
    moves as much on the port's edges); resumed runs and an edge alone
    against its chunk: bit for bit.

Clouds: three views (4000 points) of one arch under known poses,
preprocessed by JAX and carried to the port, so both packages register the
same data with the same bits (rebuilt from JAX's keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core import se3 as jse3
from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import dental_arch_cloud
from tpu3dm.multiway import posegraph as jpg
from tpu3dm.preprocess.pipeline import preprocess_points as j_preprocess
from tpu3dm_torch.core import se3
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.multiway import posegraph as ppg
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration.batch import pair_bits_shape
from tpu3dm_torch.registration.ransac import chunk_count

CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
N_CLOUDS = 3
N_POINTS = 4000
K = 512  # hypotheses an edge on the batched path


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# SE(3) assembly
# ---------------------------------------------------------------------------


def _old_make(R, t):
    T = torch.zeros((4, 4), dtype=R.dtype)
    T[:3, :3] = R
    T[:3, 3] = t
    T[3, 3] = 1.0
    return T


def _old_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def _old_exp_se3(xi, ordered=False):
    from tpu3dm_torch.ops.rowsum import chain_sum, small_matmul, small_matvec

    rho, w = xi[..., :3], xi[..., 3:]
    A, B, C = se3._coeffs(chain_sum(w * w) if ordered else torch.sum(w * w, dim=-1))
    W = se3.hat(w)
    WW = small_matmul(W, W) if ordered else W @ W
    eye = torch.eye(3, dtype=xi.dtype).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype)
    out[..., :3, :3] = R
    out[..., :3, 3] = small_matvec(V, rho) if ordered else torch.einsum("...ij,...j->...i", V, rho)
    out[..., 3, 3] = 1.0
    return out


@pytest.mark.parametrize("ordered", [False, True])
def test_out_of_place_se3_equals_the_in_place_forms(ordered):
    """Random twists at every scale (the small-angle branch included): the
    concatenated blocks are the old writes' bits."""
    gen = torch.Generator().manual_seed(7)
    xi = torch.randn((257, 6), generator=gen) * torch.logspace(-6, 0.5, 257)[:, None]
    T = se3.exp_se3(xi, ordered=ordered)
    assert torch.equal(T, _old_exp_se3(xi, ordered))
    assert torch.equal(se3.inverse(T), _old_inverse(T))
    assert torch.equal(se3.inverse(T[5]), _old_inverse(T[5]))
    for k in (0, 100, 256):
        assert torch.equal(se3.make(T[k, :3, :3], T[k, :3, 3]), _old_make(T[k, :3, :3], T[k, :3, 3]))
    assert torch.equal(se3.make(T[:, :3, :3], T[:, :3, 3]), T)


def test_jacfwd_through_se3_matches_jax():
    """d/dd log_se3(inverse(A) @ B @ exp_se3(d)) at d = 0 and at a small
    d, by forward-mode AD in both packages.  (The twist carries a leading
    axis of one: this torch's jacfwd promotes a 0-dim tensor's tangent
    through a Python scalar to float64, which the pose graph never meets.)"""
    gen = torch.Generator().manual_seed(2)
    A = se3.exp_se3(torch.randn(6, generator=gen) * 0.5)
    B = se3.exp_se3(torch.randn(6, generator=gen) * 0.5)
    Aj, Bj = jnp.asarray(A.numpy()), jnp.asarray(B.numpy())
    for d0 in (np.zeros(6, np.float32), np.float32([0.01, -0.02, 0.03, 0.05, -0.04, 0.02])):
        Jp = torch.func.jacfwd(
            lambda d: se3.log_se3(se3.inverse(A) @ B @ se3.exp_se3(d)))(torch.from_numpy(d0)[None])
        Jj = jax.jacfwd(lambda d: jse3.log_se3(jse3.inverse(Aj) @ Bj @ jse3.exp_se3(d)))(
            jnp.asarray(d0))
        np.testing.assert_allclose(Jp[0, :, 0].numpy(), np.asarray(Jj), atol=1e-5)


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------


def _rand_pose(seed, scale=0.5):
    rng = np.random.default_rng(seed)
    xi = np.r_[rng.normal(size=3) * scale, rng.normal(size=3) * scale]
    return np.asarray(jse3.exp_se3(jnp.asarray(xi, jnp.float32)))


def _edge_measurements(poses, edges, noise=0.0, seed=0):
    """T_e with x_j = T_e x_i: T_e = P_j^-1 P_i (tests/test_multiway.py)."""
    rng = np.random.default_rng(seed)
    Ts = []
    for i, j in edges:
        T = np.linalg.inv(poses[j]) @ poses[i]
        if noise > 0:
            xi = np.r_[rng.normal(size=3), rng.normal(size=3)] * noise
            T = T @ np.asarray(jse3.exp_se3(jnp.asarray(xi, jnp.float32)))
        Ts.append(T)
    return np.stack(Ts).astype(np.float32)


def _graph(case):
    """(T_meas, edges, weights, n, iterations, robust_delta, poses_true)."""
    if case == "exact_chain":
        n, noise, it, robust = 5, 0.0, 15, None
        truth = np.stack([np.eye(4, dtype=np.float32)] + [_rand_pose(i) for i in range(1, n)])
        edges = jpg.default_edges(n)
    elif case == "noisy_loop":
        n, noise, it, robust = 6, 0.02, 25, None
        truth = np.stack([np.eye(4, dtype=np.float32)]
                         + [_rand_pose(10 + i, 0.4) for i in range(1, n)])
        edges = jpg.default_edges(n)
    else:  # robust, with a gross outlier edge, a star and a repeated edge
        n, noise, it, robust = 7, 0.01, 20, 0.1
        truth = np.stack([np.eye(4, dtype=np.float32)]
                         + [_rand_pose(30 + i, 0.3) for i in range(1, n)])
        edges = jpg.default_edges(n) + [(0, 3), (0, 4), (5, 0), (1, 2), (2, 5)]
    T = _edge_measurements(truth, edges, noise, seed=1)
    w = np.linspace(0.6, 1.0, len(edges)).astype(np.float32)
    if robust is not None:
        T[2] = T[2] @ _rand_pose(99, 1.0)  # a ~60-degree alias
    return T, edges, w, n, it, robust, truth


@pytest.mark.parametrize("case", ["exact_chain", "noisy_loop", "robust_outlier"])
@pytest.mark.parametrize("solver", ["optimize_pose_graph", "optimize_pose_graph_edgewise"])
def test_pose_graph_matches_jax(solver, case):
    T, edges, w, n, it, robust, truth = _graph(case)
    want = np.asarray(getattr(jpg, solver)(
        jnp.asarray(T), jnp.asarray(np.asarray(edges, np.int32)), jnp.asarray(w),
        n_nodes=n, iterations=it, robust_delta=robust))
    got = getattr(ppg, solver)(torch.from_numpy(T), edges, torch.from_numpy(w), n_nodes=n,
                               iterations=it, robust_delta=robust).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 if robust is None else 1e-2)
    np.testing.assert_allclose(got[0], np.eye(4), atol=1e-6)
    if case == "exact_chain":
        np.testing.assert_allclose(got, truth, atol=1e-3)
    if case == "robust_outlier":
        # The alias loses its pull: every pose near its truth.
        assert np.abs(got - truth).max() < 0.02


def test_pose_graph_step_guard_zeroes_non_finite_steps():
    """A NaN measurement makes every step non-finite: both solves keep the
    identity start, as JAX's all-finite guard does."""
    T, edges, w, n, it, _, _ = _graph("noisy_loop")
    T[1, 0, 0] = np.nan
    for solver in ("optimize_pose_graph", "optimize_pose_graph_edgewise"):
        got = getattr(ppg, solver)(torch.from_numpy(T), edges, torch.from_numpy(w), n_nodes=n,
                                   iterations=3).numpy()
        want = np.asarray(getattr(jpg, solver)(
            jnp.asarray(T), jnp.asarray(np.asarray(edges, np.int32)), jnp.asarray(w),
            n_nodes=n, iterations=3))
        np.testing.assert_array_equal(got, np.broadcast_to(np.eye(4, dtype=np.float32), got.shape))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_nodes, edgewise", [(64, False), (65, True)])
def test_solve_pose_graph_switches_at_65_nodes(monkeypatch, n_nodes, edgewise):
    called = []
    monkeypatch.setattr(ppg, "optimize_pose_graph", lambda *a, **k: called.append("dense"))
    monkeypatch.setattr(ppg, "optimize_pose_graph_edgewise",
                        lambda *a, **k: called.append("edgewise"))
    ppg._solve_pose_graph(None, None, None, n_nodes=n_nodes, iterations=1)
    assert called == ["edgewise" if edgewise else "dense"]
    assert ppg._EDGEWISE_THRESHOLD == jpg._EDGEWISE_THRESHOLD


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("loop", [True, False])
def test_default_edges_match_jax(n, loop):
    assert ppg.default_edges(n, loop) == jpg.default_edges(n, loop)


# ---------------------------------------------------------------------------
# Registration along the edges
# ---------------------------------------------------------------------------


def _arrays(pc):
    return {f: np.asarray(getattr(pc, f)) for f in ("points", "normals", "features", "mask")}


@pytest.fixture(scope="module")
def views():
    """Three views of one arch (cloud k = the arch in frame k), preprocessed
    by JAX with full normals, and the same clouds carried to the port."""
    base = dental_arch_cloud(N_POINTS, seed=0)
    truth = [np.eye(4)] + [_rand_pose(20 + i, 0.15) for i in range(1, N_CLOUDS)]
    jclouds, pclouds = [], []
    for P in truth:
        Pinv = np.linalg.inv(P)
        jc = j_preprocess((base @ Pinv[:3, :3].T + Pinv[:3, 3]).astype(np.float32),
                          CFG.preprocess)
        jclouds.append(jc)
        pclouds.append(ProcessedCloud(
            full=from_reference_arrays(_arrays(jc.full), device="cpu"),
            down=from_reference_arrays(_arrays(jc.down), device="cpu"),
            voxel_size=jc.voxel_size))
    return jclouds, pclouds, np.stack(truth)


def _rot_err_deg(Ta, Tb):
    M = np.asarray(Ta, np.float64)[..., :3, :3] @ np.swapaxes(
        np.asarray(Tb, np.float64)[..., :3, :3], -1, -2)
    return np.degrees(np.arccos(np.clip((np.trace(M, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


def _apart_deg(Ta, Tb):
    """Rotation between two near-equal pose sets from ||Ra - Rb||_F = 2
    sqrt(2) sin(angle / 2), exact near 0 (the arccos of the trace is not,
    for fp32 rotations a few ulps from orthonormal)."""
    d = np.asarray(Ta, np.float64)[..., :3, :3] - np.asarray(Tb, np.float64)[..., :3, :3]
    fro = np.sqrt((d * d).sum((-2, -1)))
    return np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))


def _assert_poses_close(Tp, Tj):
    assert _apart_deg(Tp, Tj).max() < 0.05
    assert np.abs(np.asarray(Tp)[..., :3, 3] - np.asarray(Tj)[..., :3, 3]).max() < 5e-3


def _assert_solved_like_jax(res, jres):
    """The poses: JAX's solve on the port's edges, and JAX's whole run
    (module docstring)."""
    want = np.asarray(jpg._solve_pose_graph(
        jnp.asarray(res.edge_transforms), jnp.asarray(res.edges.astype(np.int32)),
        jnp.asarray(res.edge_fitness.astype(np.float32)), n_nodes=N_CLOUDS, iterations=20))
    np.testing.assert_allclose(res.poses, want, atol=1e-4)
    assert _apart_deg(res.poses, jres.poses).max() < 0.2
    assert np.abs(res.poses[:, :3, 3] - jres.poses[:, :3, 3]).max() < 0.01


def _assert_results_equal(a, b):
    for f in ("poses", "edges", "edge_transforms", "edge_fitness"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _pair_bits(key, cfg):
    """register_pair's: global_registration splits off the correspondence
    key, then a chunk draws bits(k, (K, 2)) after (key, k) = split(key)."""
    _, key = jax.random.split(key)
    rows = []
    for _ in range(chunk_count(cfg.max_iterations, cfg.batch_size)):
        key, k = jax.random.split(key)
        rows.append(np.asarray(jax.random.bits(k, (cfg.batch_size, 2), jnp.uint32)))
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def _multiway_bits(key, n_edges, cfg):
    """register_multiway's: (key, k) = split(key) an edge."""
    out = []
    for _ in range(n_edges):
        key, k = jax.random.split(key)
        out.append(_pair_bits(k, cfg))
    return out


def test_register_multiway_matches_jax(views):
    """One register_pair an edge with JAX's per-edge bits: every edge and
    pose within the pipeline's bounds, the views aligned."""
    jclouds, pclouds, truth = views
    key = jax.random.PRNGKey(3)
    jres = jpg.register_multiway(jclouds, CFG, key=key)
    bits = _multiway_bits(key, N_CLOUDS, PCFG.ransac)
    res = ppg.register_multiway(pclouds, PCFG, edge_bits=bits, device="cpu")
    np.testing.assert_array_equal(res.edges, jres.edges)
    _assert_poses_close(res.edge_transforms, jres.edge_transforms)
    np.testing.assert_allclose(res.edge_fitness, jres.edge_fitness, atol=1e-3)
    _assert_solved_like_jax(res, jres)
    assert _rot_err_deg(res.poses, truth).max() < 1.0


def test_register_multiway_resumes_bit_equal(views, tmp_path):
    """A run into a checkpoint, one edge record deleted, the run again: the
    cached edges are read back, the deleted one re-registered with the same
    bits (one generator draw an edge, cached or not), the poses bit-equal;
    and equal to a run without a store."""
    _, pclouds, _ = views
    ck = tmp_path / "ck"
    first = ppg.register_multiway(pclouds, PCFG, generator=torch.Generator().manual_seed(5),
                                  checkpoint_dir=str(ck), device="cpu")
    assert len(list(ck.glob("edge_*.npz"))) == N_CLOUDS and (ck / "poses.npz").exists()
    (ck / "edge_0001_0002.npz").unlink()
    again = ppg.register_multiway(pclouds, PCFG, generator=torch.Generator().manual_seed(5),
                                  checkpoint_dir=str(ck), device="cpu")
    _assert_results_equal(again, first)
    plain = ppg.register_multiway(pclouds, PCFG, generator=torch.Generator().manual_seed(5),
                                  device="cpu")
    _assert_results_equal(plain, first)
    np.testing.assert_array_equal(np.load(ck / "poses.npz")["poses"], first.poses)


def test_register_multiway_refuses_host_full_clouds(views):
    """Clouds whose full cloud is not on the run's device (the host clouds
    of preprocess_points_batch(full_normals=False) on a card run) raise."""
    _, pclouds, _ = views
    meta = [ProcessedCloud(full=c.full.with_(points=c.full.points.to("meta")), down=c.down,
                           voxel_size=c.voxel_size) for c in pclouds]
    with pytest.raises(ValueError, match="full_normals=True"):
        ppg.register_multiway(meta, PCFG, device="cpu")


def _batched_bits(keys, cap):
    """register_multiway_batched's: edge e's fused-step chunk bits from
    split(keys[e], n_chunks) (tests/test_torch_batch.py)."""
    n_chunks, m_s = pair_bits_shape(cap, ransac_iterations=K)[0]
    return torch.from_numpy(np.stack([
        np.stack([np.asarray(jax.random.bits(kc, (m_s,), jnp.uint32))
                  for kc in jax.random.split(k, n_chunks)]) for k in keys
    ]).astype(np.int64))


@pytest.fixture(scope="module")
def batched(views):
    jclouds, pclouds, truth = views
    key = jax.random.PRNGKey(4)
    jres = jpg.register_multiway_batched(jclouds, CFG, key=key, ransac_iterations=K)
    cap = max(c.down.capacity for c in pclouds)
    bits = _batched_bits(np.asarray(jax.random.split(key, N_CLOUDS)), cap)
    res = ppg.register_multiway_batched(pclouds, PCFG, edge_bits=bits, ransac_iterations=K,
                                        device="cpu")
    return jres, res, bits


def test_register_multiway_batched_matches_jax(views, batched):
    _, _, truth = views
    jres, res, _ = batched
    np.testing.assert_array_equal(res.edges, jres.edges)
    _assert_poses_close(res.edge_transforms, jres.edge_transforms)
    np.testing.assert_allclose(res.edge_fitness, jres.edge_fitness, atol=1e-6)
    _assert_solved_like_jax(res, jres)
    assert _rot_err_deg(res.poses, truth).max() < 1.0


def test_register_multiway_batched_edge_alone_equals_its_chunk(views, batched):
    """Each edge run alone (a chunk of one) gives its bits in the 3-edge
    chunk."""
    _, pclouds, _ = views
    _, res, bits = batched
    for e, edge in enumerate(ppg.default_edges(N_CLOUDS)):
        alone = ppg.register_multiway_batched(pclouds, PCFG, edges=[edge], edge_bits=bits[e:e + 1],
                                              ransac_iterations=K, device="cpu")
        np.testing.assert_array_equal(alone.edge_transforms[0], res.edge_transforms[e])
        np.testing.assert_array_equal(alone.edge_fitness[0], res.edge_fitness[e])


def test_register_multiway_batched_pads_the_last_chunk(views, monkeypatch):
    """With chunks of 2 edges, three edges run as two chunks, the last
    padded with edge 0 and its bits: edge 2 equals edge 2 of a call over
    (edge 2, edge 0)."""
    _, pclouds, _ = views
    monkeypatch.setattr(ppg, "EDGE_CHUNK", 2)
    edges = ppg.default_edges(N_CLOUDS)
    gen_bits = [b for b in _batched_bits(np.asarray(jax.random.split(jax.random.PRNGKey(6), 3)),
                                         max(c.down.capacity for c in pclouds))]
    three = ppg.register_multiway_batched(pclouds, PCFG, edge_bits=gen_bits,
                                          ransac_iterations=K, device="cpu")
    pair = ppg.register_multiway_batched(pclouds, PCFG, edges=edges[2:] + edges[:1],
                                         edge_bits=gen_bits[2:] + gen_bits[:1],
                                         ransac_iterations=K, device="cpu")
    np.testing.assert_array_equal(three.edge_transforms[2], pair.edge_transforms[0])


def test_register_multiway_batched_checkpoint_is_batch_granular(views, batched, tmp_path,
                                                                 monkeypatch):
    """All edges stored: reused without a dispatch, the poses bit-equal.
    One record missing: every edge registered again, bit-equal."""
    import tpu3dm_torch.registration.fused as fused

    _, pclouds, _ = views
    _, res, bits = batched
    ck = str(tmp_path / "ck")
    kw = dict(edge_bits=bits, ransac_iterations=K, checkpoint_dir=ck, device="cpu")
    first = ppg.register_multiway_batched(pclouds, PCFG, **kw)
    _assert_results_equal(first, res)
    calls = []
    real = fused.fused_register_step
    monkeypatch.setattr(fused, "fused_register_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _assert_results_equal(ppg.register_multiway_batched(pclouds, PCFG, **kw), first)
    assert calls == []
    (tmp_path / "ck" / "edge_0002_0000.npz").unlink()
    _assert_results_equal(ppg.register_multiway_batched(pclouds, PCFG, **kw), first)
    assert calls == [1]


def test_register_multiway_batched_draws_bits_in_edge_order(views, batched):
    """Without edge_bits, edge e's bits are the e-th draw of the generator."""
    from tpu3dm_torch.parallel.multipair import draw_bits

    _, pclouds, _ = views
    _, _, bits = batched
    gen = torch.Generator().manual_seed(9)
    drawn = [draw_bits(tuple(bits.shape[1:]), gen) for _ in range(N_CLOUDS)]
    a = ppg.register_multiway_batched(pclouds, PCFG, generator=torch.Generator().manual_seed(9),
                                      ransac_iterations=K, device="cpu")
    b = ppg.register_multiway_batched(pclouds, PCFG, edge_bits=drawn, ransac_iterations=K,
                                      device="cpu")
    _assert_results_equal(a, b)


def test_multiway_entry_points_refuse_mesh_and_need_cuda(views, monkeypatch):
    _, pclouds, _ = views
    with pytest.raises(TypeError, match="Mesh"):
        ppg.register_multiway_batched(pclouds, PCFG, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match=">= 2 clouds"):
        ppg.register_multiway_batched(pclouds[:1], PCFG, device="cpu")
    with pytest.raises(ValueError, match="edge_bits"):
        ppg.register_multiway(pclouds, PCFG, edge_bits=[None], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppg.register_multiway(pclouds, PCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppg.register_multiway_batched(pclouds, PCFG)
