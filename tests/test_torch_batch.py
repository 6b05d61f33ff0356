"""Port parity for tpu3dm_torch's batch API (registration/batch.py) and its
checkpoint store (multiway/checkpoint.py), on the CPU at small shapes.

Three arch pairs of 3000-6000 points (voxel 0.3) land in two capacity
buckets at ``bucket_multiple=64``.  Both packages get the same
JAX-preprocessed clouds and the same per-pair RANSAC samples: the port's
``pair_bits`` are rebuilt from JAX's ``pair_keys`` (the fused step draws a
pair's chunk bits from ``split(key, n_chunks)``).  Tolerances of the poses
are those of ``tests/test_torch_registration.py``'s fused-step test:
rotation < 0.05 deg, translation < 5e-3, RANSAC fitness within 1e-6, ICP
RMSE within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.multiway.checkpoint import CheckpointStore as JStore
from tpu3dm.multiway.checkpoint import EdgeRecord as JRecord
from tpu3dm.preprocess.pipeline import preprocess_points_batch as j_preprocess_batch
from tpu3dm.registration import batch as jbatch
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.multiway.checkpoint import CheckpointStore, EdgeRecord
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration import batch as pbatch

CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
K = 512  # hypotheses a pair
BUCKET = 64  # two buckets for these pairs (704 and 768)
KW = dict(ransac_iterations=K, bucket_multiple=BUCKET)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rot_err_deg(Ta, Tb):
    M = Ta[..., :3, :3] @ np.swapaxes(Tb[..., :3, :3], -1, -2)
    return np.degrees(np.arccos(np.clip((np.trace(M, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


def _assert_poses_match(res, ref):
    """The fused-step tolerances (module docstring)."""
    assert _rot_err_deg(res.transforms, ref.transforms).max() < 0.05
    assert np.abs(res.transforms[:, :3, 3] - ref.transforms[:, :3, 3]).max() < 5e-3
    np.testing.assert_allclose(res.ransac_fitness, ref.ransac_fitness, atol=1e-6)
    np.testing.assert_allclose(res.icp_rmse, ref.icp_rmse, atol=1e-4)


def _port_cloud(jc):
    down = {f: np.asarray(getattr(jc.down, f)) for f in ("points", "normals", "features", "mask")}
    return ProcessedCloud(full=None, down=from_reference_arrays(down, device="cpu"),
                          voxel_size=jc.voxel_size)


def _bits(keys, n_chunks=1, m_s=256):
    """[P, n_chunks, m_s]: pair p's chunk bits from split(keys[p], n_chunks)."""
    return torch.from_numpy(np.stack([
        np.stack([np.asarray(jax.random.bits(kc, (m_s,), jnp.uint32))
                  for kc in jax.random.split(k, n_chunks)]) for k in keys
    ]).astype(np.int64))


@pytest.fixture(scope="module")
def mixed():
    """Three pairs of different sizes, preprocessed by JAX and carried to the
    port; JAX's batched result with per-pair keys."""
    raw, trues = [], []
    for seed, n in ((0, 3000), (1, 6000), (2, 3500)):
        s, t, T = make_benchmark_pair(n, seed=seed, sigma=0.01)
        raw += [s, t]
        trues.append(T)
    jprocs = j_preprocess_batch(raw, CFG.preprocess, full_normals=False)
    pprocs = [_port_cloud(c) for c in jprocs]
    jpairs = [(jprocs[i], jprocs[i + 1]) for i in range(0, 6, 2)]
    ppairs = [(pprocs[i], pprocs[i + 1]) for i in range(0, 6, 2)]
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 3))
    jres = jbatch.register_pairs_batched(jpairs, CFG, pair_keys=keys, **KW)
    return jpairs, ppairs, keys, jres, np.stack(trues)


def test_register_pairs_batched_matches_jax(mixed):
    """Two buckets, JAX's per-pair samples: the poses within the fused-step
    tolerances, the same buckets, every pair recovered."""
    _, ppairs, keys, jres, trues = mixed
    res = pbatch.register_pairs_batched(ppairs, PCFG, pair_bits=_bits(keys), device="cpu", **KW)
    assert res.bucket_of_pair == jres.bucket_of_pair
    assert len(set(res.bucket_of_pair)) == 2
    _assert_poses_match(res, jres)
    assert _rot_err_deg(res.transforms, trues).max() < 2.0


def test_launch_pairs_batched_resolves_like_register(mixed):
    _, ppairs, keys, jres, _ = mixed
    pending = pbatch.launch_pairs_batched(ppairs, PCFG, pair_bits=_bits(keys), device="cpu", **KW)
    assert isinstance(pending, pbatch.PendingBatch)
    res = pending.resolve()
    assert isinstance(res, pbatch.BatchResult)
    _assert_poses_match(res, jres)


def test_register_sources_to_target_matches_jax(mixed):
    """Every source against pair 0's target, one ResidentTarget, JAX's keys."""
    jpairs, ppairs, keys, _, _ = mixed
    jres = jbatch.register_sources_to_target(
        [p[0] for p in jpairs], jbatch.ResidentTarget(jpairs[0][1]), CFG, pair_keys=keys, **KW)
    res = pbatch.register_sources_to_target(
        [p[0] for p in ppairs], pbatch.ResidentTarget(ppairs[0][1], device="cpu"), PCFG,
        pair_bits=_bits(keys), **KW)
    assert res.bucket_of_pair == jres.bucket_of_pair
    _assert_poses_match(res, jres)


def test_shared_target_equals_pair_batched(mixed):
    """JAX's contract (tests/test_batch.py: the shared target reproduces the
    pair-batched call for the same samples): in the port the two calls run
    the same step on the same values, so their outputs are equal."""
    _, ppairs, keys, _, _ = mixed
    target = ppairs[0][1]
    sources = [p[0] for p in ppairs]
    shared = pbatch.register_sources_to_target(
        sources, pbatch.ResidentTarget(target, device="cpu"), PCFG, pair_bits=_bits(keys), **KW)
    direct = pbatch.register_pairs_batched([(s, target) for s in sources], PCFG,
                                           pair_bits=_bits(keys), device="cpu", **KW)
    assert shared.bucket_of_pair == direct.bucket_of_pair
    np.testing.assert_array_equal(shared.transforms, direct.transforms)
    np.testing.assert_array_equal(shared.ransac_fitness, direct.ransac_fitness)


def test_order_and_bucket_of_pair(mixed):
    """Results come back in input order: reversing the pairs (and their
    bits) reverses the results; each pair's bucket is round_up of its larger
    cloud's valid count."""
    _, ppairs, keys, _, _ = mixed
    bits = _bits(keys)
    fwd = pbatch.register_pairs_batched(ppairs, PCFG, pair_bits=bits, device="cpu", **KW)
    rev = pbatch.register_pairs_batched(ppairs[::-1], PCFG, pair_bits=bits.flip(0),
                                        device="cpu", **KW)
    np.testing.assert_array_equal(rev.transforms, fwd.transforms[::-1])
    assert rev.bucket_of_pair == fwd.bucket_of_pair[::-1]
    for (s, t), cap in zip(ppairs, fwd.bucket_of_pair):
        n = max(int(s.down.mask.sum()), int(t.down.mask.sum()))
        assert cap == -(-n // BUCKET) * BUCKET


def test_empty_input():
    res = pbatch.register_pairs_batched([], device="cpu")
    assert res.transforms.shape == (0, 4, 4)
    assert res.bucket_of_pair == []


def test_bucket_mates_do_not_change_a_pair(mixed):
    """No power-of-two padding: a pair registered alone, or beside other
    pairs in its bucket, gets the same result bit for bit."""
    _, ppairs, keys, _, _ = mixed
    bits = _bits(keys)
    together = pbatch.register_pairs_batched(ppairs, PCFG, pair_bits=bits, device="cpu", **KW)
    alone = pbatch.register_pairs_batched(ppairs[2:], PCFG, pair_bits=bits[2:], device="cpu",
                                          **KW)
    assert together.bucket_of_pair[0] == together.bucket_of_pair[2]
    np.testing.assert_array_equal(alone.transforms[0], together.transforms[2])
    np.testing.assert_array_equal(alone.ransac_fitness[0], together.ransac_fitness[2])


def test_generator_draws_pair_after_pair(mixed):
    """Without pair_bits, pair i's bits are the i-th draw of the generator
    (seed 0 by default), so they do not depend on the buckets."""
    _, ppairs, _, _, _ = mixed
    shape, extra = pbatch.pair_bits_shape(704, ransac_iterations=K)
    assert shape == (1, 256) and extra is None
    gen = torch.Generator().manual_seed(0)
    bits = torch.stack([torch.randint(0, 1 << 32, shape, generator=gen) for _ in ppairs])
    a = pbatch.register_pairs_batched(ppairs, PCFG, pair_bits=bits, device="cpu", **KW)
    b = pbatch.register_pairs_batched(ppairs, PCFG, device="cpu", **KW)
    np.testing.assert_array_equal(a.transforms, b.transforms)


@pytest.mark.parametrize("case", ["rows", "shape", "extra", "mesh", "names"])
def test_batch_rejects_bad_arguments(mixed, case):
    """pair_bits of the wrong count or shape raise (as the fused step does
    for its sample_bits); the adaptive budget needs its extra bits; a mesh
    must be a parallel.mesh.Mesh; a checkpoint needs pair names."""
    _, ppairs, keys, _, _ = mixed
    bits = _bits(keys)
    kw = {
        "rows": dict(pair_bits=bits[:2]),
        "shape": dict(pair_bits=bits[:, :, :255]),
        "extra": dict(pair_bits=bits, adapt_iterations=2 * K),
        "mesh": dict(mesh=object()),
        "names": dict(checkpoint=object()),
    }[case]
    err = TypeError if case == "mesh" else ValueError
    with pytest.raises(err):
        pbatch.register_pairs_batched(ppairs, PCFG, device="cpu", **KW, **kw)


def test_resident_target_keeps_max_caps(mixed):
    """LRU over capacities: the least recently used one is evicted and
    packed again from the cloud, equal to before."""
    _, ppairs, _, _, _ = mixed
    rt = pbatch.ResidentTarget(ppairs[0][1], max_caps=2, device="cpu")
    a = rt.at_cap(768)
    rt.at_cap(1024)
    assert rt.at_cap(768) is a
    rt.at_cap(1280)  # evicts 1024
    assert list(rt._by_cap) == [768, 1280]
    b = rt.at_cap(1024)
    assert list(rt._by_cap) == [1280, 1024]
    n = rt.n_valid
    assert b[2].sum() == n and not b[0][n:].any()
    torch.testing.assert_close(b[0][:n], ppairs[0][1].down.points[:n], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Checkpoint resume (JAX's tests/test_batch.py and tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_checkpoint_resume_skips_completed(mixed, tmp_path, monkeypatch):
    """A second call over a complete store dispatches nothing: every pair is
    restored (bucket -1) with the first call's results.  A store missing one
    record recomputes only that pair."""
    _, ppairs, keys, _, _ = mixed
    names = [f"pair-{i}" for i in range(len(ppairs))]
    store = CheckpointStore(tmp_path / "ck")
    kw = dict(pair_bits=_bits(keys), checkpoint=store, pair_names=names, device="cpu", **KW)
    first = pbatch.register_pairs_batched(ppairs, PCFG, **kw)
    assert all(c > 0 for c in first.bucket_of_pair)

    def boom(*a, **k):
        raise AssertionError("dispatched despite a complete checkpoint")

    with monkeypatch.context() as m:
        m.setattr(pbatch, "fused_register_step", boom)
        again = pbatch.register_pairs_batched(ppairs, PCFG, **kw)
    assert again.bucket_of_pair == [-1] * len(ppairs)
    np.testing.assert_allclose(again.transforms, first.transforms, atol=1e-6)
    np.testing.assert_allclose(again.ransac_fitness, first.ransac_fitness, atol=1e-6)

    store._pair_path(names[1]).unlink()  # a run killed before pair 1's record
    partial = pbatch.register_pairs_batched(ppairs, PCFG, **kw)
    assert partial.bucket_of_pair[0] == partial.bucket_of_pair[2] == -1
    assert partial.bucket_of_pair[1] == first.bucket_of_pair[1]
    np.testing.assert_array_equal(partial.transforms[1], first.transforms[1])


def _record(seed=0):
    rng = np.random.default_rng(seed)
    return dict(transformation=np.eye(4) + rng.normal(0, 1e-3, (4, 4)), fitness=0.87,
                inlier_rmse=0.012, iterations=23)


def test_checkpoint_edges_roundtrip_and_corrupt_record(tmp_path):
    store = CheckpointStore(tmp_path)
    assert store.get_edge(0, 1) is None
    rec = EdgeRecord(**_record())
    store.put_edge(0, 1, rec)
    back = store.get_edge(0, 1)
    np.testing.assert_allclose(back.transformation, rec.transformation)
    assert back.fitness == pytest.approx(rec.fitness) and back.iterations == rec.iterations
    assert store.completed_edges() == [(0, 1)]
    store.put_pair("a.ply\tb.ply", rec)
    store.put_edge(2, 3, rec)
    (tmp_path / "edge_0002_0003.npz").write_bytes(b"not an npz")
    store._pair_path("a.ply\tb.ply").write_bytes(b"torn")
    assert store.get_edge(2, 3) is None and store.get_pair("a.ply\tb.ply") is None
    store.write_manifest(n_clouds=3, edges=[[0, 1], [1, 2]], voxel_size=0.3)
    assert store.read_manifest()["n_clouds"] == 3
    store.write_poses(np.stack([np.eye(4)] * 3))
    np.testing.assert_allclose(store.read_poses(), np.stack([np.eye(4)] * 3))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_store_reads_across_packages(tmp_path, writer):
    """One on-disk layout: a store written by either package reads in the
    other (edges, pairs, manifest, poses)."""
    Writer, Reader = (JStore, CheckpointStore) if writer == "jax" else (CheckpointStore, JStore)
    Rec = JRecord if writer == "jax" else EdgeRecord
    w = Writer(tmp_path)
    w.put_edge(3, 4, Rec(**_record(1)))
    w.put_pair("src.ply\ttgt.ply", Rec(**_record(2)))
    w.write_manifest(n_clouds=5, voxel_size=0.3)
    w.write_poses(np.stack([np.eye(4)] * 5))
    r = Reader(tmp_path)
    assert r.completed_edges() == [(3, 4)]
    np.testing.assert_array_equal(r.get_edge(3, 4).transformation, _record(1)["transformation"])
    pair = r.get_pair("src.ply\ttgt.ply")
    np.testing.assert_array_equal(pair.transformation, _record(2)["transformation"])
    assert (pair.fitness, pair.inlier_rmse, pair.iterations) == (0.87, 0.012, 23)
    assert r.read_manifest() == {"n_clouds": 5, "voxel_size": 0.3}
    assert r.read_poses().shape == (5, 4, 4)


# ---------------------------------------------------------------------------
# The packing: whole buckets on the device, against the per-cloud oracle
# ---------------------------------------------------------------------------

PACK_KW = dict(ransac_iterations=256, icp_iterations=2, bucket_multiple=256)


@pytest.fixture(scope="module")
def port_clouds():
    """Eight clouds of four 3000-point arch pairs, preprocessed by the port
    on the CPU: prefix masks at one down capacity, 630-660 valid rows."""
    from tpu3dm_torch.io.synthetic import make_benchmark_pair as p_pair
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    raw = [c for s in range(4) for c in p_pair(3000, seed=s, sigma=0.01)[:2]]
    return preprocess_points_batch(raw, PCFG.preprocess, full_normals=False, device="cpu")


def _reshaped(cloud, extra, holes, seed):
    """``cloud`` at down capacity N + ``extra``: its valid rows in order, at
    scattered rows with ``holes`` (else first), and noise in every other row,
    which the packing must drop."""
    from tpu3dm_torch.core.cloud import PointCloud

    gen = torch.Generator().manual_seed(seed)
    d = cloud.down
    n, cap = int(d.mask.sum()), d.points.shape[0] + extra
    pos = (torch.sort(torch.randperm(cap, generator=gen)[:n]).values if holes
           else torch.arange(n))

    def fill(x):
        out = torch.randn((cap,) + tuple(x.shape[1:]), generator=gen)
        out[pos] = x[d.mask]
        return out

    mask = torch.zeros(cap, dtype=torch.bool)
    mask[pos] = True
    down = PointCloud(points=fill(d.points), mask=mask, normals=fill(d.normals),
                      features=fill(d.features))
    return ProcessedCloud(full=cloud.full, down=down, voxel_size=cloud.voxel_size)


def _oracle_pack(lanes, cap, dev, *, normals):
    """The per-cloud packing: each lane's valid rows cut or zero-padded to
    ``cap``, moved to ``dev``, a mask over the first of them, and the lanes
    stacked in lane order."""

    def rows(x, m):
        x = x[m][:cap]
        return torch.cat([x, x.new_zeros((cap - x.shape[0],) + tuple(x.shape[1:]))]).to(dev)

    parts = []
    for c in lanes:
        d = c.down
        mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
        mask[: min(int(d.mask.sum()), cap)] = True
        parts.append([rows(d.points, d.mask), rows(d.features, d.mask), mask]
                     + ([rows(d.normals, d.mask)] if normals else []))
    return tuple(torch.stack(f) for f in zip(*parts))


def _pack_case(case, clouds):
    """(pairs or (sources, target), device, mesh) of a packing case."""
    from tpu3dm_torch.parallel import mesh as pmesh

    a, b, c, d, e, f, g, h = clouds
    cpu = torch.device("cpu")
    if case == "holes":
        a, b, c, d = (_reshaped(x, 96, True, i) for i, x in enumerate((a, b, c, d)))
        return [(a, b), (c, d), (b, c)], cpu, None
    if case == "two_capacities":
        # Each bucket side holds clouds of down capacity 768 and 1024.
        a, d = (_reshaped(x, 256, False, i) for i, x in enumerate((a, d)))
        return [(a, b), (c, d), (e, a), (d, f)], cpu, None
    if case == "shared_cloud":
        return [(a, b), (a, c), (d, b), (a, b)], cpu, None
    if case == "other_device":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the clouds lie on the CPU, the run on the card")
        return [(a, b), (c, d), (e, f)], torch.device("cuda"), None
    if case == "mesh_quantum_4":
        mesh = pmesh.make_mesh(4, 1, devices=[cpu] * 4)
        return [(a, b), (c, d), (e, f), (g, h), (b, c)], cpu, mesh
    if case == "to_target":
        a, b, c = (_reshaped(x, 96, True, i) for i, x in enumerate((a, b, c)))
        return ([a, b, c, d], h), cpu, None
    assert case == "to_target_with_holes"
    # The target's valid rows have holes; a source of two clouds' rows takes
    # a second capacity, so the target is packed at two.
    from tpu3dm_torch.core.cloud import PointCloud

    a, h = (_reshaped(x, 96, True, i) for i, x in enumerate((a, h)))
    both = PointCloud(**{f: torch.cat([getattr(b.down, f), getattr(e.down, f)])
                         for f in ("points", "mask", "normals", "features")})
    return ([a, dataclasses.replace(b, down=both), c], h), cpu, None


def _run_pack_case(case, clouds, monkeypatch, pack):
    """Register the case with ``pack`` as the bucket packing: (the arguments
    each step took, the BatchResult)."""
    pairs, dev, mesh = _pack_case(case, clouds)
    calls = []
    real_step, real_mesh = pbatch.fused_register_step, pbatch.batched_register

    def step(*args, **kw):
        calls.append(args + (kw.get("extra_bits"),))
        return real_step(*args, **kw)

    def mesh_step(m, *args, **kw):
        calls.append(args + (kw.get("extra_bits"),))
        return real_mesh(m, *args, **kw)

    with monkeypatch.context() as m:
        m.setattr(pbatch, "_pack", pack)
        m.setattr(pbatch, "fused_register_step", step)
        m.setattr(pbatch, "batched_register", mesh_step)
        gen = torch.Generator().manual_seed(11)
        if case.startswith("to_target"):
            sources, target = pairs
            resident = pbatch.ResidentTarget(target, device=dev)
            if pack is _oracle_pack:  # the target packed per cloud too
                resident.at_cap = lambda cap: tuple(
                    x[0] for x in _oracle_pack([target], cap, dev, normals=True))
            res = pbatch.register_sources_to_target(sources, resident, PCFG, generator=gen,
                                                    **PACK_KW)
        else:
            res = pbatch.register_pairs_batched(pairs, PCFG, generator=gen, mesh=mesh,
                                                device=dev, **PACK_KW)
    return calls, res


@pytest.mark.parametrize("case", ["holes", "two_capacities", "shared_cloud", "other_device",
                                  "mesh_quantum_4", "to_target", "to_target_with_holes"])
def test_bucket_packing_equals_the_per_cloud_packing(port_clouds, monkeypatch, case):
    """Every tensor the step takes (points, features, masks, normals, bits,
    in lane order; a resident target's too, from ``ResidentTarget.at_cap``)
    equals the per-cloud packing's, ``torch.equal``; so do the results under
    the same generator, bit for bit."""
    got_calls, got = _run_pack_case(case, port_clouds, monkeypatch, pbatch._pack)
    want_calls, want = _run_pack_case(case, port_clouds, monkeypatch, _oracle_pack)
    assert len(got_calls) == len(want_calls) > 0
    for g_args, w_args in zip(got_calls, want_calls):
        assert len(g_args) == len(w_args)
        for x, y in zip(g_args, w_args):
            if y is None:
                assert x is None
            else:
                assert x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
    assert got.bucket_of_pair == want.bucket_of_pair
    for field in ("transforms", "ransac_fitness", "icp_rmse"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    if case == "two_capacities":
        assert {c.down.points.shape[0] for pr in _pack_case(case, port_clouds)[0]
                for c in pr} == {768, 1024}
    if case == "mesh_quantum_4":
        assert [len(args[0]) for args in got_calls] == [8]
    if case == "to_target_with_holes":
        assert sorted(set(got.bucket_of_pair)) == [768, 1536]


def _pack_ops(pairs, monkeypatch):
    """(aten ops that started inside the call's ``batch.pack`` spans, the
    call's counters) of one ``launch_pairs_batched`` under ``torch.profiler``
    on the CPU, the step itself stubbed."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3dm_torch.utils.profiler import Profiler

    def step(src_pts, *args, **kw):
        b = src_pts.shape[0]
        return torch.eye(4).expand(b, 4, 4), torch.zeros(b), torch.zeros(b)

    shape, _ = pbatch.pair_bits_shape(768, ransac_iterations=PACK_KW["ransac_iterations"])
    bits = torch.zeros((len(pairs),) + shape, dtype=torch.int64)
    Profiler.reset()
    with monkeypatch.context() as m:
        m.setattr(pbatch, "fused_register_step", step)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pending = pbatch.launch_pairs_batched(pairs, PCFG, pair_bits=bits, device="cpu",
                                                  **PACK_KW)
    counters = Profiler.counters()
    packs = [(s.start_ns, s.end_ns) for s in Profiler.spans() if s.name == "batch.pack"]
    Profiler.reset()
    assert set(pending.resolve().bucket_of_pair) == {768}
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [e.name for e in prof.events() if e.name.startswith("aten::")
           and any(a <= t0 + e.time_range.start * 1e3 <= b for a, b in packs)]
    return ops, counters


def test_packing_op_count_does_not_grow_with_the_batch(port_clouds, monkeypatch):
    """4 and 16 pairs of distinct clouds in one bucket: the same aten ops in
    the packing, and one host read of the counts a call."""

    def pairs(n):
        copies = [dataclasses.replace(port_clouds[i % 8]) for i in range(2 * n)]
        return [(copies[2 * i], copies[2 * i + 1]) for i in range(n)]

    ops4, counters4 = _pack_ops(pairs(4), monkeypatch)
    ops16, counters16 = _pack_ops(pairs(16), monkeypatch)
    assert ops4 and sorted(ops4) == sorted(ops16)
    assert counters4["batch.pack_syncs"] == counters16["batch.pack_syncs"] == 1
    assert (counters4["batch.pairs"], counters16["batch.pairs"]) == (4, 16)
