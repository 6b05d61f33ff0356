"""The large path's device route: the voxel grid and the KD partition on the
clouds' device, for callers whose clouds are already tensors.

CPU tests: the route's grid gives the host grid's means bit for bit;
``kd_perm_device`` gives ``kd_perm``'s leaf sets on tie-free seeded clouds
(a block multiple and not; blocks 64 and 512) with no leaf above ``block``
points; ``prepare_large_cloud`` of a tensor gathers and pads on its device;
``register_arrays_large`` on tensors agrees with the host route and with the
benchmark's plain reference (``perfbench/reference/large.py``) at 16,384
points; the verification's batches (restarts as lanes of one
``ransac_two_mode``, the candidates' poses as one ``icp_refine``, both
tiers of its search) equal the one-at-a-time runs and elect what they
elect; ``cuda_graph`` leaves the CPU's loop as it is.  The ``gpu`` tests
hold the card's grid and partition to the host routes at 1M points, and
the ICPs replayed as CUDA graphs to the eager loops (answers and kernel
launches), beside a batch-API step replayed on another thread; they skip
without a card.

This file imports neither JAX nor tpu3dm; on a card run
``python -m pytest --noconftest tests/test_torch_large_device.py``.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.lib import synthetic
from perfbench.reference import large as reference
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.ops import nn_sparse
from tpu3dm_torch.registration import large

VOXEL = 0.3
CFG = PipelineConfig.with_voxel_size(VOXEL)
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "perfbench" / "configs"
                     / "arch1m.json").read_text())["limits"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the card tests run there with --noconftest")
    return torch.device("cuda")


def _pair(n, seed, device="cpu"):
    """(src [n, 3], tgt [n, 3], T_true [4, 4]) float32, float32, float64: an
    arch pair of the benchmark's generator, tgt ~ T_true src."""
    src, tgt, T = synthetic.arch_pairs(1, n, synthetic.generator(seed, 0, device), sigma=0.002)
    return src[0], tgt[0], T[0]


def _leaves(n, block):
    """The leaf sizes of ``kd_perm``'s recursion, in order."""
    if n <= block:
        return [n]
    k = (n // block // 2) * block if n % block == 0 else n // 2
    return _leaves(k, block) + _leaves(n - k, block)


def _leaf_sets(perm, n, block):
    out, at = [], 0
    for s in _leaves(n, block):
        out.append(frozenset(np.asarray(perm[at:at + s]).tolist()))
        at += s
    return out


@pytest.mark.parametrize("n, seed", [(16384, 1), (9000, 2), (70001, 3)])
def test_device_grid_means_equal_the_host_grid(n, seed):
    pts = _pair(n, seed)[0]
    host = large.downsample_large(pts.numpy(), VOXEL, device="cpu")
    dev = large.downsample_large(pts, VOXEL, device="cpu")
    for field in ("points", "mask", "normals", "features"):
        assert torch.equal(getattr(dev, field), getattr(host, field)), field
    assert int(dev.mask.sum()) > 100


def _tie_free(n, seed):
    """[n, 3] float32 points whose coordinates differ on every axis: seeded
    permutations of 0..n-1, each axis scaled (exactly) by its own power of
    two, so the widest axis changes from level to level."""
    g = torch.Generator().manual_seed(seed)
    cols = [torch.randperm(n, generator=g).to(torch.float32) * s for s in (1.0, 0.5, 0.25)]
    return torch.stack(cols, dim=1)


@pytest.mark.parametrize("n", [4096, 16384, 20000, 70001, 262144])
@pytest.mark.parametrize("block", [64, 512])
def test_kd_perm_device_gives_the_host_leaves(n, block):
    pts = _tie_free(n, n + block)
    host = nn_sparse.kd_perm(pts.numpy(), block)
    dev = nn_sparse.kd_perm_device(pts, block)
    assert dev.dtype == torch.int64
    assert sorted(dev.tolist()) == list(range(n))
    assert _leaf_sets(dev, n, block) == _leaf_sets(host, n, block)
    assert max(_leaves(n, block)) <= block


def test_kd_levels_follow_the_host_rule():
    assert nn_sparse.kd_levels(512, 512) == []
    assert nn_sparse.kd_levels(1536, 512) == [[(1536, True)], [(512, False), (1024, True)]]
    assert nn_sparse.kd_levels(1000, 64) == [[(1000, True)], [(500, True)] * 2,
                                             [(250, True)] * 4, [(125, True)] * 8]
    levels = nn_sparse.kd_levels(1 << 20, 512)
    assert len(levels) == 11 and len(levels[-1]) == 1024
    assert nn_sparse.kd_perm_device(torch.zeros((0, 3)), 512).numel() == 0


def test_prepare_large_cloud_of_a_tensor_stays_on_its_device():
    src = _pair(5000, 4)[0]
    nrm = torch.randn(src.shape, generator=torch.Generator().manual_seed(0))
    lc = large.prepare_large_cloud(src, block=512, normals=nrm, device="cpu")
    host = large.prepare_large_cloud(src.numpy(), block=512, normals=nrm.numpy(), device="cpu")
    assert isinstance(lc.perm, torch.Tensor) and lc.perm.device == src.device
    assert (lc.n, lc.block, lc.points.shape[0]) == (5000, 512, 5120)
    assert torch.equal(lc.points[:5000], src[lc.perm])
    assert torch.equal(lc.normals[:5000], nrm[lc.perm])
    assert bool((lc.points[5000:] == nn_sparse.SPARSE_PAD).all())
    assert bool((lc.normals[5000:] == 0).all())
    assert torch.equal(lc.mask, host.mask)
    # The same leaves, so the same rows in each leaf.
    assert _leaf_sets(lc.perm, 5000, 512) == _leaf_sets(host.perm, 5000, 512)


def _rot_deg(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    f = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3])
    return math.degrees(2.0 * math.asin(min(1.0, f / math.sqrt(8.0))))


@pytest.fixture(scope="module")
def registered():
    """One 16,384-point arch pair through both routes at block 64, and the
    plain reference's optimum from the true pose."""
    src, tgt, T_true = _pair(16384, 5)
    kw = dict(device="cpu", key=3, block=64, w=8)
    host = large.register_arrays_large(src.numpy(), tgt.numpy(), CFG, **kw)
    dev = large.register_arrays_large(src, tgt, CFG, **kw)
    ref = reference.icp(src, tgt, T_true, voxel=VOXEL, normal_radius=2 * VOXEL,
                        normal_max_nn=30, thresh=0.4 * VOXEL)
    return host, dev, ref, T_true


def test_register_arrays_large_on_tensors_agrees_with_the_host_route(registered):
    (fh, ch), (fd, cd), _, _ = registered
    # The same grid means and bits: the coarse stage is the same, bit for bit.
    assert torch.equal(cd.transformation, ch.transformation)
    assert torch.equal(cd.fitness, ch.fitness)
    # The same leaves, ordered otherwise inside a leaf: sums in another order.
    assert _rot_deg(fd.transformation, fh.transformation) < 1e-3
    assert (fd.transformation[:3, 3] - fh.transformation[:3, 3]).abs().max() < 1e-4
    assert abs(float(fd.fitness) - float(fh.fitness)) < 1e-3
    assert abs(float(fd.inlier_rmse) - float(fh.inlier_rmse)) < 1e-3 * float(fh.inlier_rmse)


def test_register_arrays_large_on_tensors_agrees_with_the_reference(registered):
    """Within the benchmark's limits (perfbench/configs/arch1m.json): the
    pose of the exact-neighbour ICP optimum, the fitness, and the RMSE, which
    lies above the exact one where the w-block search finds a farther
    neighbour for some rows."""
    _, (fd, _), (T_ref, fit_ref, rmse_ref, _), T_true = registered
    assert _rot_deg(fd.transformation, T_ref) < LIMITS["pose_gap_deg"]
    assert _rot_deg(fd.transformation, T_true) < 0.05
    assert abs(float(fd.fitness) - fit_ref) < LIMITS["fitness_gap"]
    gap = (float(fd.inlier_rmse) - rmse_ref) / rmse_ref
    assert -0.01 < gap < LIMITS["rmse_gap_rel"]


def _featured(n, seed):
    """The downsampled, featured clouds of an arch pair, and its true pose."""
    from tpu3dm_torch.preprocess.pipeline import down_features

    src, tgt, T_true = _pair(n, seed)
    pp = CFG.preprocess
    down = [down_features(large.downsample_large(x, VOXEL, device="cpu"), pp.normal_radius,
                          pp.fpfh_radius, normal_max_nn=pp.normal_max_nn,
                          fpfh_max_nn=pp.fpfh_max_nn, share_knn=True) for x in (src, tgt)]
    return (*down, T_true)


@pytest.fixture(scope="module")
def featured():
    return _featured(16384, 8)


@pytest.mark.parametrize("tier", ["dense", "tiled"])
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_refine_of_a_pose_batch_equals_it_pose_by_pose(featured, monkeypatch, tier,
                                                          point_to_plane):
    """``icp_refine`` on poses [C, 4, 4] (the verification's batch): each
    pose's steps, stop and grading as one ``icp_refine`` of it (the same
    correspondences; sums in another order), poses that stop at different
    iterations included, in both tiers of the search (the tiled one taken
    here by lowering the dense tier's limit below the clouds' size)."""
    from tpu3dm_torch.core import se3
    from tpu3dm_torch.ops import nn
    from tpu3dm_torch.registration.icp import icp_refine

    if tier == "tiled":
        monkeypatch.setattr(nn, "DENSE_MAX_ENTRIES", 1024)
    sd, td, T_true = featured
    g = torch.Generator().manual_seed(2)
    T0 = torch.stack([se3.exp_se3(0.05 * k * torch.randn(6, generator=g)) @ T_true.float()
                      for k in range(5)])
    stops = set()
    for thresh, iters in ((0.45, 5), (0.12, 30)):
        kw = dict(dist_thresh=thresh, max_iterations=iters, point_to_plane=point_to_plane)
        got = icp_refine(sd, td, T0, **kw)
        assert got.transformation.shape == (5, 4, 4) and got.iterations.shape == (5,)
        for k in range(T0.shape[0]):
            one = icp_refine(sd, td, T0[k], **kw)
            assert int(got.iterations[k]) == int(one.iterations)
            assert (got.transformation[k] - one.transformation).abs().max() < 1e-5
            assert abs(float(got.fitness[k]) - float(one.fitness)) < 1e-6
            assert (abs(float(got.inlier_rmse[k]) - float(one.inlier_rmse))
                    < 1e-5 * float(one.inlier_rmse))
        stops |= set(got.iterations.tolist())
    assert len(stops) > 2


def test_cuda_graph_on_the_cpu_is_the_eager_loop(featured):
    """``cuda_graph`` asks for CUDA graphs only where the poses lie on CUDA:
    on the CPU the loop runs eagerly, the same answer bit for bit."""
    from tpu3dm_torch.registration.icp import icp_refine

    sd, td, T_true = featured
    kw = dict(dist_thresh=0.12, max_iterations=30, point_to_plane=True)
    a = icp_refine(sd, td, T_true.float(), cuda_graph=True, **kw)
    b = icp_refine(sd, td, T_true.float(), **kw)
    assert int(a.iterations) == int(b.iterations) > 1
    for x, y in ((a.transformation, b.transformation), (a.fitness, b.fitness),
                 (a.inlier_rmse, b.inlier_rmse)):
        assert torch.equal(x, y)


def test_nn_search_of_a_query_batch_above_the_dense_limit():
    """Queries [C, Nq, 3] against one target, Nq x Nt above DENSE_MAX_ENTRIES:
    the tiled tier over all their rows at once, each row's answer that of
    its own pose's search."""
    from tpu3dm_torch.ops import nn

    n = 4100
    assert n * n > nn.DENSE_MAX_ENTRIES
    g = torch.Generator().manual_seed(0)
    tgt = torch.rand(n, 3, generator=g)
    tmask = torch.rand(n, generator=g) < 0.9
    q = torch.rand(2, n, 3, generator=g)
    qmask = torch.rand(n, generator=g) < 0.9
    d2, idx = nn.nn_search(q, tgt, qmask.expand(2, n), tmask)
    assert d2.shape == idx.shape == (2, n)
    for k in range(2):
        d2k, ik = nn.nn_search_tiled(q[k], tgt, qmask, tmask)
        assert torch.equal(idx[k], ik) and torch.equal(d2[k], d2k)


def test_ransac_two_mode_restarts_equal_one_run_each():
    """Restarts as lanes of one ``ransac_two_mode``: each lane's two modes,
    counts, hypotheses evaluated and RMSEs those of its own run with its
    bits, lanes that stop after different chunks included (correspondence
    sets with different outlier shares under one mask)."""
    from tpu3dm_torch.core import se3
    from tpu3dm_torch.parallel.multipair import draw_bits
    from tpu3dm_torch.registration import ransac

    g = torch.Generator().manual_seed(0)
    m = 400
    p = torch.rand(m, 3, generator=g) * 4.0
    T = se3.exp_se3(torch.tensor([0.1, -0.2, 0.3, 0.5, 0.1, -0.2]))
    q = se3.apply(T, p) + 0.002 * torch.randn(m, 3, generator=g)
    valid = torch.rand(m, generator=g) < 0.9
    qs = []
    for share in (0.0, 0.75, 0.85):
        bad = torch.rand(m, generator=g) < share
        qs.append(torch.where(bad[:, None], torch.rand(m, 3, generator=g) * 4.0, q))
    kw = dict(dist_thresh=0.05, max_iterations=4096, batch_size=256)
    bits = draw_bits((3, ransac.chunk_count(4096, 256), 256, 2), g)
    lanes = ransac.ransac_two_mode(p.expand(3, -1, -1), torch.stack(qs), valid, bits, **kw)
    hypotheses = set()
    for r in range(3):
        one = ransac.ransac_two_mode(p, qs[r], valid, bits[r], **kw)
        for lane, alone in zip(lanes, one):
            assert int(lane.iterations[r]) == int(alone.iterations)
            assert float(lane.fitness[r]) == float(alone.fitness)
            assert torch.equal(lane.transformation[r], alone.transformation)
            assert abs(float(lane.inlier_rmse[r]) - float(alone.inlier_rmse)) < 1e-6
        hypotheses.add(int(one[0].iterations))
    assert len(hypotheses) == 3


@pytest.mark.parametrize("noise_ratio", [0.0, 0.3])
def test_verified_restarts_elect_what_one_at_a_time_elects(featured, noise_ratio):
    """``coarse_pose_with_verification`` (restarts as lanes, the candidates'
    ICPs as one batch) elects the pose that restart-by-restart RANSAC and
    candidate-by-candidate ICP elect from the same generator, with the
    correspondence noise of each restart drawn in the same order."""
    import dataclasses

    from tpu3dm_torch.registration import fused, ransac
    from tpu3dm_torch.registration.icp import icp_refine

    sd, td, _ = featured
    cfg = dataclasses.replace(CFG, ransac=dataclasses.replace(CFG.ransac,
                                                              noise_ratio=noise_ratio))
    rc = cfg.ransac
    got = large.coarse_pose_with_verification(sd, td, cfg, restarts=3,
                                              generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    cands = [c for _ in range(3) for c in ransac.global_registration_two_mode(sd, td, rc, None, g)]
    vers = []
    for c in cands:
        v = icp_refine(sd, td, c.transformation, dist_thresh=rc.dist_thresh, max_iterations=5,
                       point_to_plane=False)
        vers.append(icp_refine(sd, td, v.transformation, dist_thresh=cfg.icp.dist_thresh,
                               max_iterations=5, point_to_plane=False))
    fit_max = max(float(c.fitness) for c in cands)
    near = [float(c.fitness) >= fused.RESCUE_TIE_RATIO * fit_max for c in cands]
    best = max(float(v.fitness) for v, n in zip(vers, near) if n)
    eligible = [k for k, n in enumerate(near)
                if n or float(vers[k].fitness) >= fused.RESCUE_OVERRIDE_MARGIN * best]
    k = max(eligible, key=lambda k: (float(vers[k].fitness), -float(vers[k].inlier_rmse)))
    assert (got.transformation - vers[k].transformation).abs().max() < 1e-4
    same = [float(c.fitness) for c, v in zip(cands, vers)
            if (v.transformation - vers[k].transformation).abs().max() < 1e-4]
    assert float(got.fitness) in same


def test_register_arrays_large_takes_one_route():
    z = torch.zeros((600, 3))
    with pytest.raises(TypeError, match="both"):
        large.register_arrays_large(z, z.numpy(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        large.register_arrays_large(z, z, device="cpu", mesh=_mesh_on_cpu())


def _mesh_on_cpu():
    from tpu3dm_torch.parallel.mesh import make_mesh

    return make_mesh(1, 2, devices=[torch.device("cpu")] * 2)


@pytest.mark.gpu
def test_device_grid_and_partition_equal_the_host_routes_at_1m_points(cuda_device):
    src = _pair(1 << 20, 6, device=cuda_device)[0]
    host_pts = src.cpu().numpy()
    host = large.downsample_large(host_pts, VOXEL, device=cuda_device)
    dev = large.downsample_large(src, VOXEL, device=cuda_device)
    assert torch.equal(dev.points, host.points) and torch.equal(dev.mask, host.mask)
    pts = _tie_free(1 << 20, 7)
    perm = nn_sparse.kd_perm_device(pts.to(cuda_device), 512)
    assert perm.device.type == "cuda"
    assert _leaf_sets(perm.cpu(), 1 << 20, 512) == _leaf_sets(
        nn_sparse.kd_perm(pts.numpy(), 512), 1 << 20, 512)


@pytest.mark.gpu
def test_icp_graph_replays_equal_the_eager_loops_at_1m_points(cuda_device, monkeypatch):
    """The large path's three ICPs with their iterations replayed as CUDA
    graphs (the verification's 8 poses, point to point; the polish, point to
    plane; the block-sparse ICP on 1M points) give the eager loops' poses,
    fitness, RMSE and iterations bit for bit, and their kernel launches
    (counted at each replay), twice in a row (the second captures reuse the
    first's memory pool); with a batch-API step captured and replayed in the
    same pool on a second thread between the two, and replayed there again
    all through the second, every replay with its eager answers; and the
    verification's batch in the tiled tier too."""
    import threading

    from tpu3dm_torch.core import se3
    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts
    from tpu3dm_torch.ops import nn
    from tpu3dm_torch.preprocess.pipeline import down_features
    from tpu3dm_torch.registration import graphs
    from tpu3dm_torch.registration.icp import icp_refine

    src, tgt, T_true = _pair(1 << 20, 6, device=cuda_device)
    pp = CFG.preprocess
    sd, td = (down_features(large.downsample_large(x, VOXEL, device=cuda_device),
                            pp.normal_radius, pp.fpfh_radius, normal_max_nn=pp.normal_max_nn,
                            fpfh_max_nn=pp.fpfh_max_nn, share_knn=True) for x in (src, tgt))
    ls = large.prepare_large_cloud(src, device=cuda_device)
    lt = large.prepare_large_cloud(tgt, device=cuda_device)
    lt = dataclasses.replace(lt, normals=large.donor_normals(lt, td))
    g = torch.Generator().manual_seed(4)
    T0 = torch.stack([se3.exp_se3(0.05 * k * torch.randn(6, generator=g)) @ T_true.float().cpu()
                      for k in range(8)]).to(cuda_device)
    T1 = T0[3]

    def answers(graph, down_src=sd, down_tgt=td):
        out = []
        for res in (
            icp_refine(down_src, down_tgt, T0, dist_thresh=0.45, max_iterations=5,
                       point_to_plane=False, cuda_graph=graph),
            icp_refine(down_src, down_tgt, T1, dist_thresh=0.12, max_iterations=30,
                       point_to_plane=True, cuda_graph=graph),
            large.icp_refine_large(ls, lt, T1, dist_thresh=0.12, max_iterations=30,
                                   cuda_graph=graph),
        ):
            out += [res.transformation, res.fitness, res.inlier_rmse,
                    torch.as_tensor(res.iterations)]
        return out

    def launches():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in KERNELS.items()}

    # A batch-API step on its own thread: its intermediates and outputs lie
    # in the pool the ICPs' graphs share.
    steps, x = graphs.StepGraphs(), torch.rand(256, 1024, device=cuda_device)

    def step(x):
        y = torch.exp(x) * x
        return y.sum(dim=1), (y * y).cumsum(dim=1)

    want = step(x)
    replays, stop = [], threading.Event()

    def batch_steps(done):
        while True:
            replays.append(all(torch.equal(a, b) for a, b in
                               zip(steps.run(cuda_device, "step", (x,), step), want)))
            if done():
                return

    reset_launch_counts()
    eager = answers(False)
    counts = launches()
    assert counts["nn_blocksparse"] > 0
    for run in range(2):
        if run == 1:  # replayed all through this run
            worker = threading.Thread(target=batch_steps, args=(stop.is_set,))
            worker.start()
        reset_launch_counts()
        for x_, y in zip(answers(True), eager):
            assert torch.equal(x_.cpu(), y.cpu())
        assert launches() == counts
        if run == 0:  # seen, captured and replayed between the two runs
            worker = threading.Thread(target=batch_steps, args=(lambda: len(replays) == 3,))
            worker.start()
        else:
            stop.set()
        worker.join(timeout=300)
        assert not worker.is_alive()
    assert len(replays) >= 4 and all(replays) and steps.graphs() == 1
    monkeypatch.setattr(nn, "DENSE_MAX_ENTRIES", 1024)
    kw = dict(dist_thresh=0.45, max_iterations=5, point_to_plane=False)
    a = icp_refine(sd, td, T0, cuda_graph=True, **kw)
    b = icp_refine(sd, td, T0, **kw)
    assert torch.equal(a.transformation, b.transformation)
    assert torch.equal(a.iterations, b.iterations)


@pytest.mark.gpu
def test_bits_of_a_generator_on_the_card_are_drawn_there(cuda_device):
    """``draw_bits`` draws from a generator on its device: a generator on
    the card gives uint32 values there, the same for the same seed."""
    from tpu3dm_torch.parallel.multipair import draw_bits

    a, b = (draw_bits((25, 4096, 2), torch.Generator(device=cuda_device).manual_seed(7))
            for _ in range(2))
    assert a.device.type == "cuda" and a.dtype == torch.int64 and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 32 and int(a.max()) >= 1 << 31
