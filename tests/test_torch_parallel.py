"""Port parity for tpu3dm_torch's device mesh (parallel/), on the CPU.

JAX runs on the 8 simulated CPU devices of tests/conftest.py; the port runs
on ``[torch.device("cpu")] * n`` meshes (a device may repeat).  The same
numpy inputs go through both packages; RANSAC bits are rebuilt from JAX's
keys.  Bounds:

  - mesh shapes and defaulting: equal to JAX's; a wrong size raises
    ValueError, a non-mesh TypeError, no CUDA RuntimeError.
  - collectives: the ring shift, the ordered sum (position order, bit for
    bit against a left-to-right sum) and the all-gather, exact.
  - ``ring_nn_search``: indices equal to JAX's ring and to the port's
    ``nn_search`` on the whole arrays; d2 within rtol = atol = 1e-5 of JAX's
    (JAX's own bound, tests/test_parallel.py), and bit-equal to the port's
    whole search at d = 3 (direct squared differences, elementwise).
  - ``sharded_ransac``: the same champion count as JAX (fitness equal) and
    the transform within 1e-4; the true pose within 2 deg.
  - ``batched_ransac`` on a 4x2 mesh: counts equal to JAX's (fitness within
    1e-6), transforms within 1e-4; bit-equal to one ``ransac_pair_step``
    over all pairs.
  - ``batched_register``: bit-equal across meshes of 1, 2, 4 and 8 pair
    shards; against JAX's on its 8-device mesh the fused-step tolerances
    (tests/test_torch_batch.py): rotation < 0.05 deg, translation < 5e-3,
    fitness within 1e-6, RMSE within 1e-4.
  - the callers' mesh branches (batch API with the quantum pad, serve
    engine, multi-way): bit-equal to ``mesh=None``.
  - two processes over gloo (``initialize_distributed``): pair-DP
    (``batched_ransac`` on 4x1) and the ring ICP (1x4), bit-equal to the
    one-process mesh; each child is given 120 s.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.parallel import mesh as jmesh
from tpu3dm.parallel.multipair import batched_ransac as j_batched_ransac
from tpu3dm.parallel.register import batched_register as j_batched_register
from tpu3dm.parallel.ring_nn import ring_nn_search as j_ring_nn_search
from tpu3dm.parallel.sharded_ransac import sharded_ransac as j_sharded_ransac
from tpu3dm.preprocess.pipeline import preprocess_points_batch as j_preprocess_batch
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.ops.nn import nn_search
from tpu3dm_torch.parallel import mesh as pmesh
from tpu3dm_torch.parallel.multipair import batched_ransac, ransac_pair_step
from tpu3dm_torch.parallel.register import batched_register
from tpu3dm_torch.parallel.ring_nn import ring_nn_search
from tpu3dm_torch.parallel.sharded_ransac import sharded_ransac
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration import batch as pbatch
from tpu3dm_torch.registration.hypotheses import sample_row_count
from tpu3dm_torch.serve import ServeConfig, ServeEngine

CPU = torch.device("cpu")
CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(n_pair, n_block):
    return pmesh.make_mesh(n_pair, n_block, devices=[CPU] * (n_pair * n_block))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rot_err_deg(Ta, Tb):
    M = np.asarray(Ta, np.float64)[..., :3, :3] @ np.swapaxes(
        np.asarray(Tb, np.float64)[..., :3, :3], -1, -2)
    return np.degrees(np.arccos(np.clip((np.trace(M, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


# --- mesh and collectives -----------------------------------------------------


@pytest.mark.parametrize("args, shape", [
    ((2, 4), {"pair": 2, "block": 4}),
    ((), {"pair": 8, "block": 1}),
    ((None, 2), {"pair": 4, "block": 2}),
    ((1, None), {"pair": 1, "block": 8}),
])
def test_mesh_shapes_match_jax(args, shape):
    assert pmesh.make_mesh(*args, devices=[CPU] * 8).shape == shape
    assert dict(jmesh.make_mesh(*args).shape) == shape


def test_mesh_rejects_bad_sizes_and_needs_cuda(monkeypatch):
    with pytest.raises(ValueError, match="3x2"):
        pmesh.make_mesh(3, 2, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jmesh.make_mesh(3, 2)
    with pytest.raises(TypeError, match="Mesh"):
        pmesh.check_mesh("here", object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()


def test_line_collectives_are_exact():
    """The ring shift moves position i to i + 1; psum adds in position
    order (bit-equal to a left-to-right sum, not to a tree); all_gather
    stacks in order; split and concat round-trip."""
    m = _mesh(1, 4)
    line = m.line("block")
    x = torch.arange(8.0).reshape(4, 2)
    shards = line.split(x)
    shifted = line.shift(shards)
    assert [int(s[0, 0]) for s in shifted] == [6, 0, 2, 4]
    vals = [torch.tensor(v, dtype=torch.float32) for v in (1e8, 1.0, -1e8, 1.0)]
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    assert torch.equal(line.psum(vals), want) and float(want) == 1.0
    assert torch.equal(line.all_gather(vals), torch.stack(vals))
    assert torch.equal(line.concat(shards), x)
    with pytest.raises(ValueError):
        line.split(torch.zeros(6, 2))
    pair = _mesh(4, 2).line("pair")
    assert pair.n == 4 and pair.local() == [0, 1, 2, 3]


# --- ring NN ------------------------------------------------------------------


@pytest.mark.parametrize("d, nq, nt", [(3, 512, 1024), (33, 256, 512)])
def test_ring_nn_matches_jax_and_whole_search(d, nq, nt):
    rng = np.random.default_rng(d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    t = rng.normal(size=(nt, d)).astype(np.float32)
    qm = rng.random(nq) > 0.05
    tm = rng.random(nt) > 0.05
    d2j, ij = j_ring_nn_search(jmesh.make_mesh(1, 8), jnp.asarray(q), jnp.asarray(t),
                               jnp.asarray(qm), jnp.asarray(tm))
    args = [torch.from_numpy(a) for a in (q, t, qm, tm)]
    d2p, ip = ring_nn_search(_mesh(1, 8), *args)
    d2w, iw = nn_search(*args)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d2p.numpy(), np.asarray(d2j), rtol=1e-5, atol=1e-5)
    assert torch.equal(ip[args[2]], iw[args[2]])
    if d == 3:
        assert torch.equal(d2p[args[2]], d2w[args[2]])
    else:
        np.testing.assert_allclose(d2p.numpy(), d2w.numpy(), rtol=1e-5, atol=1e-5)


# --- RANSAC -------------------------------------------------------------------


def _corres_problem(n, outlier_frac, seed):
    """tests/test_parallel.py's problem: p uniform in [-2, 2]^3, q = T p with
    the first outlier_frac rows replaced by uniform points."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.4
    from tpu3dm_torch.core import se3 as pse3

    xi = np.r_[rng.normal(size=3) * 0.4, w].astype(np.float32)
    T = pse3.exp_se3(torch.from_numpy(xi)).numpy()
    q = p @ T[:3, :3].T + T[:3, 3]
    n_out = int(n * outlier_frac)
    q[:n_out] = rng.uniform(-2, 2, size=(n_out, 3))
    return p, q.astype(np.float32), T


def test_sharded_ransac_matches_jax():
    """Mesh 1x8, 2048 hypotheses (256 a position), position b's bits from
    JAX's fold_in(key, b)."""
    p, q, T = _corres_problem(400, 0.4, seed=2)
    valid = np.ones(400, bool)
    valid[::37] = False  # compaction moves rows
    key = jax.random.PRNGKey(0)
    iters, nb = 2048, 8
    jres = j_sharded_ransac(jmesh.make_mesh(1, nb), jnp.asarray(p), jnp.asarray(q),
                            jnp.asarray(valid), key, dist_thresh=0.1, iterations=iters)
    bits = np.stack([np.asarray(jax.random.bits(jax.random.fold_in(key, b),
                                                (iters // nb, 2), jnp.uint32))
                     for b in range(nb)]).astype(np.int64)
    pres = sharded_ransac(_mesh(1, nb), torch.from_numpy(p), torch.from_numpy(q),
                          torch.from_numpy(valid), torch.from_numpy(bits), dist_thresh=0.1,
                          iterations=iters)
    assert float(pres.fitness) == float(jres.fitness) and float(pres.fitness) > 0.5
    np.testing.assert_allclose(pres.transformation.numpy(), np.asarray(jres.transformation),
                               atol=1e-4)
    np.testing.assert_allclose(float(pres.inlier_rmse), float(jres.inlier_rmse), atol=1e-5)
    assert int(pres.iterations) == int(jres.iterations) == iters
    assert _rot_err_deg(pres.transformation.numpy(), T) < 2.0


def _pair_chunk_bits(keys, n_chunks, m_s):
    """[P, n_chunks, m_s]: pair p's chunk i from bits(split(keys[p], n_chunks)[i], (m_s,))."""
    return torch.from_numpy(np.stack([
        np.stack([np.asarray(jax.random.bits(kc, (m_s,), jnp.uint32))
                  for kc in jax.random.split(k, n_chunks)]) for k in keys
    ]).astype(np.int64))


def test_batched_ransac_pair_dp_matches_jax():
    """8 pairs on a 4x2 mesh: JAX's counts and transforms, every pair
    recovered, and bit-equal to one ransac_pair_step over all 8."""
    P, M, K, B = 8, 256, 1024, 512
    ps, qs, Ts = zip(*[_corres_problem(M, 0.3, seed=10 + i) for i in range(P)])
    p, q = np.stack(ps), np.stack(qs)
    v = np.ones((P, M), bool)
    keys = jax.random.split(jax.random.PRNGKey(1), P)
    Tj, fj = j_batched_ransac(jmesh.make_mesh(4, 2), jnp.asarray(p), jnp.asarray(q),
                              jnp.asarray(v), keys, dist_thresh=0.1, iterations=K, batch_size=B)
    bits = _pair_chunk_bits(keys, K // B, sample_row_count(M, B))
    args = [torch.from_numpy(a) for a in (p, q, v)]
    Tp, fp = batched_ransac(_mesh(4, 2), *args, bits, dist_thresh=0.1, iterations=K,
                            batch_size=B)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=1e-6)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-4)
    assert _rot_err_deg(Tp.numpy(), np.stack(Ts)).max() < 2.5 and fp.min() > 0.55
    Td, cd = ransac_pair_step(*args, bits, dist_thresh=0.1, iterations=K, batch_size=B)
    assert torch.equal(Tp, Td)
    assert torch.equal(fp, cd.to(torch.float32) / M)


# --- batched_register and the callers -----------------------------------------


def _port_cloud(jc):
    down = {f: np.asarray(getattr(jc.down, f)) for f in ("points", "normals", "features", "mask")}
    return ProcessedCloud(full=None, down=from_reference_arrays(down, device="cpu"),
                          voxel_size=jc.voxel_size)


@pytest.fixture(scope="module")
def stacked():
    """Two JAX-preprocessed arch pairs, each tiled to 8 lanes at one
    capacity, in both packages' layouts, with 8 pair keys."""
    raw = []
    for seed in range(2):
        s, t, _ = make_benchmark_pair(3000, seed=seed, sigma=0.01)
        raw += [s, t]
    jprocs = j_preprocess_batch(raw, CFG.preprocess, full_normals=False)
    cap = max(c.down.capacity for c in jprocs)

    def padto(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((cap - a.shape[0],) + a.shape[1:], a.dtype)])

    arrays = []
    for which in (0, 1):
        for f in ("points", "features", "mask", "normals"):
            rows = [padto(getattr(jprocs[2 * (j % 2) + which].down, f)) for j in range(8)]
            arrays.append(np.stack(rows))
    keys = jax.random.split(jax.random.PRNGKey(4), 8)
    return arrays, keys, cap, [_port_cloud(c) for c in jprocs]


REG_KW = dict(ransac_iterations=256, icp_iterations=4, approx_score=True)


def test_batched_register_is_mesh_free_and_matches_jax(stacked):
    arrays, keys, cap, _ = stacked
    bits = _pair_chunk_bits(keys, 1, sample_row_count(cap, 256))
    outs = [batched_register(_mesh(n, 1), *[torch.from_numpy(a) for a in arrays], bits,
                             **REG_KW) for n in (1, 2, 4, 8)]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
    Tj, fj, rj = j_batched_register(jmesh.make_mesh(8, 1), *[jnp.asarray(a) for a in arrays],
                                    keys, **REG_KW)
    Tp, fp, rp = (x.numpy() for x in outs[0])
    assert _rot_err_deg(Tp, np.asarray(Tj)).max() < 0.05
    assert np.abs(Tp[:, :3, 3] - np.asarray(Tj)[:, :3, 3]).max() < 5e-3
    np.testing.assert_allclose(fp, np.asarray(fj), atol=1e-6)
    np.testing.assert_allclose(rp, np.asarray(rj), atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        batched_register(_mesh(4, 1), *[torch.from_numpy(a[:6]) for a in arrays], bits[:6],
                         **REG_KW)


def test_register_pairs_batched_mesh_equals_no_mesh(stacked):
    """Three pairs over a 2x2 mesh: the bucket is padded to 4 with a repeat
    of its first pair, and every pair's result is the call's without mesh."""
    *_, procs = stacked
    pairs = [(procs[0], procs[1]), (procs[2], procs[3]), (procs[0], procs[3])]
    kw = dict(bucket_multiple=64, generator=None, device="cpu", **REG_KW)
    ref = pbatch.register_pairs_batched(pairs, PCFG, **kw)
    got = pbatch.register_pairs_batched(pairs, PCFG, mesh=_mesh(2, 2), **kw)
    np.testing.assert_array_equal(got.transforms, ref.transforms)
    np.testing.assert_array_equal(got.ransac_fitness, ref.ransac_fitness)
    np.testing.assert_array_equal(got.icp_rmse, ref.icp_rmse)
    assert got.bucket_of_pair == ref.bucket_of_pair


def test_serve_engine_mesh_equals_no_mesh(stacked):
    """ServeEngine(mesh=...) skips the resident route and splits each
    micro-batch over the pair axis; the responses equal mesh=None's."""
    *_, procs = stacked
    serve = ServeConfig(max_batch=4, max_delay_ms=200.0, bucket_multiple=64,
                        ransac_iterations=256, icp_iterations=4)
    reqs = [(procs[0], procs[1]), (procs[2], procs[3]), (procs[2], procs[1]),
            (procs[0], procs[3])]
    out = []
    for mesh in (None, _mesh(4, 1)):
        with ServeEngine(PCFG, serve, mesh=mesh, device="cpu") as eng:
            futs = [eng.submit(*r) for r in reqs]
            out.append([f.result(timeout=600) for f in futs])
            assert mesh is None or eng.stats()["shared_target_requests"] == 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.transformation, b.transformation)
        assert a.fitness == b.fitness and a.inlier_rmse == b.inlier_rmse


def test_register_multiway_batched_mesh_equals_no_mesh(stacked):
    """Three views, the chain + loop edges (3) over a 2x1 mesh (the chunk
    rounded to the pair quantum): edges and poses equal mesh=None's."""
    from tpu3dm_torch.multiway.posegraph import register_multiway_batched

    *_, procs = stacked
    kw = dict(generator=None, ransac_iterations=256, icp_iterations=4, device="cpu",
              pose_graph_iters=5)
    a = register_multiway_batched(procs[:3], PCFG, **kw)
    b = register_multiway_batched(procs[:3], PCFG, mesh=_mesh(2, 1), **kw)
    assert len(a.edges) % 2 == 1  # the quantum pad runs
    for f in ("poses", "edges", "edge_transforms", "edge_fitness"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# --- two processes ------------------------------------------------------------

# The cases both the child processes and the one-process reference run:
# pair-DP RANSAC on a 4x1 mesh and the ring ICP on a 1x4 mesh.
_CASES = textwrap.dedent(
    """
    import numpy as np
    import torch

    from tpu3dm_torch.core import se3
    from tpu3dm_torch.parallel.multipair import batched_ransac
    from tpu3dm_torch.parallel.sharded_icp import icp_refine_sharded
    from tpu3dm_torch.registration.hypotheses import sample_row_count


    def distributed_cases(pair_mesh, block_mesh):
        rng = np.random.default_rng(0)
        P, M = 4, 256
        p = rng.normal(size=(P, M, 3)).astype(np.float32)
        q = p + 0.01
        bits = torch.from_numpy(rng.integers(0, 1 << 32, (P, 2, sample_row_count(M, 256)),
                                             dtype=np.int64))
        Ts, fit = batched_ransac(pair_mesh, torch.from_numpy(p), torch.from_numpy(q),
                                 torch.ones(P, M, dtype=torch.bool), bits, dist_thresh=0.1,
                                 iterations=512, batch_size=256)
        tgt = rng.normal(size=(2001, 3)).astype(np.float32)
        nrm = rng.normal(size=(2001, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        xi = torch.tensor([0.02, -0.01, 0.015, 0.03, -0.02, 0.01])
        Tinv = torch.linalg.inv(se3.exp_se3(xi)).numpy()
        src = (tgt @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
        res = icp_refine_sharded(block_mesh, src, tgt, np.eye(4), tgt_normals=nrm,
                                 dist_thresh=0.3, max_iterations=20)
        return dict(Ts=Ts.numpy(), fit=fit.numpy(), T=res.transformation.numpy(),
                    fitness=res.fitness.numpy(), rmse=res.inlier_rmse.numpy(),
                    it=res.iterations.numpy())
    """
)

_WORKER = _CASES + textwrap.dedent(
    """
    import sys

    torch.set_num_threads(1)
    coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from tpu3dm_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(coordinator=coord, num_processes=2, process_id=rank,
                           backend="gloo")
    import torch.distributed as dist

    assert dist.get_world_size() == 2
    cpu = torch.device("cpu")  # two devices a process: four in all
    res = distributed_cases(make_mesh(4, 1, devices=[cpu] * 2),
                            make_mesh(1, 4, devices=[cpu] * 2))
    np.savez(out, **res)
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)
    """
)


def test_two_process_mesh_equals_one_process(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(r), str(tmp_path / f"r{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, out
    cases: dict = {}
    exec(_CASES, cases)
    ref = cases["distributed_cases"](_mesh(4, 1), _mesh(1, 4))
    assert ref["fit"].min() > 0.99 and float(ref["fitness"]) > 0.99
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r}: {k}")
