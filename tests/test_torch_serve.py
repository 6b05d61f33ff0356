"""Port parity for tpu3dm_torch's serving tier (serve/), on the CPU at the
shapes of tests/test_serve.py: 1500-point arch pairs at voxel 0.3,
``max_batch`` 8, ``bucket_multiple`` 64, 512 hypotheses, 4 ICP iterations.

Engine parity: both engines get the same JAX-preprocessed clouds, and the
port's ``request_bits`` is replaced by JAX's bits rebuilt from
``_request_key(seq)`` (the fused step draws a pair's chunk bits from
``split(key, n_chunks)``), so both draw the same triples.  Poses are held
to the fused step's tolerances (tests/test_torch_batch.py): rotation < 0.05
deg, translation < 5e-3, fitness within 1e-6, RMSE within 1e-4.  The rest
ports tests/test_serve.py's cases to the port's engine and server.
"""

import dataclasses
import json
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dm.core.config import PipelineConfig
from tpu3dm.io.synthetic import make_benchmark_pair
from tpu3dm.preprocess.pipeline import preprocess_points_batch as j_preprocess_batch
from tpu3dm.serve import ServeConfig as JServeConfig
from tpu3dm.serve import ServeEngine as JServeEngine
from tpu3dm.serve.engine import _request_key
from tpu3dm_torch.core.cloud import from_reference_arrays
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.io.ply import write_ply
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration import batch as pbatch
from tpu3dm_torch.serve import (
    EngineOverloaded,
    PairResult,
    RegistrationClient,
    RegistrationServer,
    ServeConfig,
    ServeEngine,
)
from tpu3dm_torch.serve import engine as pengine

N_POINTS = 1500
SERVE = ServeConfig(max_batch=8, max_delay_ms=250.0, bucket_multiple=64, ransac_iterations=512,
                    icp_iterations=4)
CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rot_err_deg(Ta, Tb):
    M = np.asarray(Ta)[..., :3, :3] @ np.swapaxes(np.asarray(Tb)[..., :3, :3], -1, -2)
    return np.degrees(np.arccos(np.clip((np.trace(M, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


def _jax_request_bits(seq, cap, knobs):
    """JAX's bits for request ``seq``: chunk i from split(_request_key(seq),
    n_chunks)[i], bits(k, (m_s,))."""
    (n_chunks, m_s), extra = knobs.bits_shape(cap)
    assert extra is None
    key = jnp.asarray(_request_key(seq))
    bits = np.stack([np.asarray(jax.random.bits(k, (m_s,), jnp.uint32))
                     for k in jax.random.split(key, n_chunks)])
    return torch.from_numpy(bits.astype(np.int64)), None


@pytest.fixture
def jax_bits(monkeypatch):
    monkeypatch.setattr(pengine, "request_bits", _jax_request_bits)


def _port_cloud(jc):
    down = {f: np.asarray(getattr(jc.down, f)) for f in ("points", "normals", "features", "mask")}
    return ProcessedCloud(full=None, down=from_reference_arrays(down, device="cpu"),
                          voxel_size=jc.voxel_size)


@pytest.fixture(scope="module")
def pairs():
    """Four JAX-preprocessed (src, tgt) requests, their port copies and
    their true poses."""
    raw, trues = [], []
    for seed in range(4):
        s, t, T = make_benchmark_pair(N_POINTS, seed=seed, sigma=0.005)
        raw.extend([s, t])
        trues.append(T)
    jprocs = j_preprocess_batch(raw, CFG.preprocess, full_normals=False)
    pprocs = [_port_cloud(c) for c in jprocs]
    jpairs = [(jprocs[i], jprocs[i + 1]) for i in range(0, 8, 2)]
    ppairs = [(pprocs[i], pprocs[i + 1]) for i in range(0, 8, 2)]
    return jpairs, ppairs, np.stack(trues)


@pytest.fixture(scope="module")
def jax_results(pairs):
    """JAX's engine on the four requests, submitted together."""
    jpairs, _, _ = pairs
    jserve = JServeConfig(**dataclasses.asdict(SERVE))
    with JServeEngine(CFG, jserve) as eng:
        futs = [eng.submit(s, t) for s, t in jpairs]
        return [f.result(timeout=600) for f in futs]


def _raw(seed):
    return make_benchmark_pair(N_POINTS, seed=seed, sigma=0.005)


def test_engine_matches_jax_engine(pairs, jax_results, jax_bits):
    """Four quick submits coalesce into one micro-batch; each result is
    JAX's engine's within the fused-step tolerances, in JAX's bucket."""
    _, ppairs, trues = pairs
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        futs = [eng.submit(s, t) for s, t in ppairs]
        results = [f.result(timeout=600) for f in futs]
        st = eng.stats()
    assert st["requests"] == 4 and st["batches"] == 1 and st["mean_batch_size"] == 4.0
    assert st["latency_ms"]["p95"] > 0
    T = np.stack([r.transformation for r in results])
    Tj = np.stack([np.asarray(r.transformation) for r in jax_results])
    assert _rot_err_deg(T, Tj).max() < 0.05
    assert np.abs(T[:, :3, 3] - Tj[:, :3, 3]).max() < 5e-3
    for r, rj in zip(results, jax_results):
        assert isinstance(r, PairResult) and r.bucket == rj.bucket > 0
        assert abs(r.fitness - rj.fitness) < 1e-6
        assert abs(r.inlier_rmse - rj.inlier_rmse) < 1e-4
    assert _rot_err_deg(T, trues).max() < 2.0


def test_engine_equals_direct_batched_call(pairs):
    """The engine is the batch API with each request's own bits:
    ``register_pairs_batched`` with request_bits(0..3) gives the same bits."""
    _, ppairs, _ = pairs
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        results = [f.result(timeout=600) for f in [eng.submit(s, t) for s, t in ppairs]]
        knobs = eng._knobs
    bits = [pengine.request_bits(i, r.bucket, knobs)[0] for i, r in enumerate(results)]
    direct = pbatch.register_pairs_batched(
        ppairs, PCFG, pair_bits=bits, bucket_multiple=SERVE.bucket_multiple,
        ransac_iterations=SERVE.ransac_iterations, icp_iterations=SERVE.icp_iterations,
        icp_solves_per_nn=SERVE.icp_solves_per_nn, approx_score=SERVE.approx_score, **CPU)
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.transformation, direct.transforms[i])


def test_request_bits_follow_the_request_alone():
    """A request's bits depend on its sequence number and capacity only,
    in pair_bits_shape's layout, below bucket 256 too."""
    knobs = pbatch._Knobs.of(PCFG, ransac_iterations=512, icp_iterations=4, icp_solves_per_nn=2,
                             approx_score=True, sample_mode="roll")
    a, extra = pengine.request_bits(7, 128, knobs)
    assert extra is None and tuple(a.shape) == pbatch.pair_bits_shape(128, ransac_iterations=512)[0]
    assert tuple(a.shape) == (1, 128)
    assert torch.equal(a, pengine.request_bits(7, 128, knobs)[0])
    assert not torch.equal(a, pengine.request_bits(8, 128, knobs)[0])
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 32


def test_engine_result_independent_of_batch_composition(pairs):
    """Request 0 alone equals request 0 in a grouped micro-batch, bit for
    bit (the same bits, and sums that do not follow the batch)."""
    _, ppairs, _ = pairs
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        grouped = [eng.submit(s, t) for s, t in ppairs]
        g0 = grouped[0].result(timeout=600)
        assert eng.stats()["batches"] == 1
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        solo = eng.register(*ppairs[0], timeout=600)
    np.testing.assert_array_equal(solo.transformation, g0.transformation)
    assert solo.fitness == g0.fitness and solo.inlier_rmse == g0.inlier_rmse


def test_engine_rejects_after_close(pairs):
    _, ppairs, _ = pairs
    eng = ServeEngine(PCFG, SERVE, **CPU)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(*ppairs[0])


def test_engine_shared_target_path(pairs, jax_bits):
    """Requests sharing one target object take the resident route, equal
    the pair-batched route's results, and reuse the resident entry."""
    _, ppairs, trues = pairs
    target = ppairs[0][1]
    sources = [p[0] for p in ppairs]
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        results = [f.result(timeout=600) for f in [eng.submit(s, target) for s in sources]]
        st = eng.stats()
    assert st["shared_target_requests"] == 4 and st["resident_targets"] == 1
    assert _rot_err_deg(results[0].transformation, trues[0]) < 2.0
    with ServeEngine(PCFG, dataclasses.replace(SERVE, target_resident_min=0), **CPU) as eng:
        direct = [f.result(timeout=600) for f in [eng.submit(s, target) for s in sources]]
        assert eng.stats()["shared_target_requests"] == 0
    for r, d in zip(results, direct):
        np.testing.assert_array_equal(r.transformation, d.transformation)
    with ServeEngine(PCFG, dataclasses.replace(SERVE, target_resident_min=1), **CPU) as eng:
        eng.register(sources[0], target, timeout=600)
        eng.register(sources[1], target, timeout=600)
        st = eng.stats()
    assert st["shared_target_requests"] == 2 and st["resident_targets"] == 1


def test_resident_target_caps_bounded(pairs):
    """A long-lived target keeps at most max_caps capacity variants (LRU)."""
    _, ppairs, _ = pairs
    rt = pbatch.ResidentTarget(ppairs[0][1], max_caps=2, device="cpu")
    rt.at_cap(64)
    rt.at_cap(128)
    buf64 = rt.at_cap(64)
    rt.at_cap(192)
    assert set(rt._by_cap) == {64, 192}, "LRU must evict 128, not 64"
    assert rt.at_cap(64) is buf64
    assert rt.at_cap(128)[0].shape == (128, 3)


def test_resident_target_lru_keeps_hot_model(pairs):
    """Eviction drops the least recently used resident, never the hot model."""
    _, ppairs, _ = pairs
    eng = ServeEngine(PCFG, SERVE, **CPU)
    try:
        hot = ppairs[0][1]
        eng._resident(hot)
        for i in range(40):
            eng._resident(ppairs[(i % 3) + 1][1] if i % 10 == 9 else
                          ProcessedCloud(full=hot.full, down=hot.down, voxel_size=hot.voxel_size))
            if i % 5 == 0:
                eng._resident(hot)
        eng._resident(hot)
        assert id(hot) in eng._residents
        assert len(eng._residents) <= SERVE.resident_targets_max
        assert isinstance(eng._residents[id(hot)][1], pbatch.ResidentTarget)
    finally:
        eng.close()


def test_engine_overload_shedding(pairs):
    """Past max_pending a submit raises EngineOverloaded at once; accepted
    work completes and the engine accepts again once drained."""
    _, ppairs, _ = pairs
    shed = dataclasses.replace(SERVE, max_pending=2, max_delay_ms=500.0, max_batch=2)
    with ServeEngine(PCFG, shed, **CPU) as eng:
        f1, f2 = eng.submit(*ppairs[0]), eng.submit(*ppairs[1])
        with pytest.raises(EngineOverloaded, match="max_pending"):
            eng.submit(*ppairs[2])
        r1, r2 = f1.result(timeout=600), f2.result(timeout=600)
        r3 = eng.register(*ppairs[2], timeout=600)
        st = eng.stats()
    assert st["shed"] == 1 and st["requests"] == 3 and st["errors"] == 0
    assert all(r.fitness > 0.0 for r in (r1, r2, r3))


def test_engine_latency_decomposition(pairs):
    """queue + pack + device account for the latency."""
    _, ppairs, _ = pairs
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        r = eng.register(*ppairs[0], timeout=600)
        st = eng.stats()
    assert r.queue_ms >= 0.0 and r.pack_ms > 0.0 and r.device_ms > 0.0
    assert abs(r.latency_ms - (r.queue_ms + r.pack_ms + r.device_ms)) < 250.0
    assert st["pack_ms_per_batch"]["p50"] > 0 and st["device_ms_per_batch"]["p50"] > 0


def test_engine_resolver_thread_gives_the_same_results(pairs):
    """pipeline_depth=1 resolves on the resolver thread, with the same bits."""
    _, ppairs, _ = pairs
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        inline = eng.register(*ppairs[1], timeout=600)
    with ServeEngine(PCFG, dataclasses.replace(SERVE, pipeline_depth=1), **CPU) as eng:
        piped = eng.register(*ppairs[1], timeout=600)
        assert eng.stats()["batches"] == 1
    np.testing.assert_array_equal(piped.transformation, inline.transformation)


def test_engine_prewarm(pairs):
    """prewarm runs the launch routes and does not perturb results."""
    _, ppairs, _ = pairs
    cap = ppairs[0][0].down.capacity
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        baseline = eng.register(*ppairs[0], timeout=600)
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        dt = eng.prewarm(caps=[cap], batch_sizes=[2])
        assert dt > 0.0
        warmed = eng.register(*ppairs[0], timeout=600)
        assert eng.stats()["requests"] == 1
    np.testing.assert_array_equal(warmed.transformation, baseline.transformation)


def test_engine_errors_reach_the_futures(pairs):
    """A failing micro-batch fails its futures; the dispatcher lives on."""
    _, ppairs, _ = pairs
    broken = ProcessedCloud(full=None, down=None, voxel_size=0.3)
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        with pytest.raises(AttributeError):
            eng.register(broken, ppairs[0][1], timeout=600)
        assert eng.register(*ppairs[0], timeout=600).fitness > 0.0
        assert eng.stats()["errors"] == 1


def test_engine_mesh_raises(pairs):
    with pytest.raises(TypeError, match="mesh"):
        ServeEngine(PCFG, SERVE, mesh=object(), **CPU)


def test_engine_and_server_need_cuda_by_default(monkeypatch):
    """device=None means CUDA; without it the engine and the server raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(PCFG, SERVE)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegistrationServer(port=0, pipeline=PCFG, serve=SERVE)


def test_register_points_preprocesses_on_the_engine_device():
    s, t, T_true = _raw(0)
    with ServeEngine(PCFG, SERVE, **CPU) as eng:
        r = eng.register_points(s, t, timeout=600)
    assert _rot_err_deg(r.transformation, T_true) < 2.0 and r.fitness > 0.2


def _server(**kw):
    return RegistrationServer(port=0, pipeline=PCFG, serve=kw.pop("serve", SERVE), device="cpu",
                              **kw)


def test_server_roundtrip_inline_and_path(tmp_path):
    """Inline base64 source against a cached path target."""
    s, t, T_true = _raw(0)
    tgt_path = tmp_path / "target.ply"
    write_ply(tgt_path, t.astype(np.float32))
    with _server() as server:
        with RegistrationClient(server.host, server.port, timeout=600) as c:
            assert c.ping()
            r1 = c.register(s, str(tgt_path))
            r2 = c.register(s, str(tgt_path))
            st = c.stats()
    for r in (r1, r2):
        assert _rot_err_deg(np.asarray(r["transformation"]), T_true) < 2.0
        assert r["fitness"] > 0.2 and r["bucket"] > 0
    assert st["requests"] == 2
    assert st["cloud_cache"] == {"hits": 1, "misses": 1}


def test_server_concurrent_clients_share_a_batch():
    raws = [_raw(s) for s in range(4)]
    results, errors = [None] * 4, []
    with _server() as server:

        def worker(i):
            try:
                with RegistrationClient(server.host, server.port, timeout=600) as c:
                    results[i] = c.register(raws[i][0], raws[i][1])
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append((i, e))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert not any(th.is_alive() for th in threads)
        st = server.engine.stats()
    assert not errors, errors
    for i in range(4):
        assert _rot_err_deg(np.asarray(results[i]["transformation"]), raws[i][2]) < 2.0
    assert st["requests"] == 4 and st["batches"] <= 3, st


def test_server_error_reporting():
    with _server() as server:
        with RegistrationClient(server.host, server.port, timeout=600) as c:
            with pytest.raises(RuntimeError, match="nonexistent"):
                c.register("/nonexistent/cloud.ply", "/nonexistent/cloud2.ply")
            assert c.ping()


def test_server_malformed_lines():
    with _server() as server:
        with socket.create_connection((server.host, server.port), timeout=60) as s:
            rfile = s.makefile("rb")
            for payload in [b"not json\n", b"{}\n", b'{"op": "explode"}\n',
                            b'{"op": "register", "source": 42, "target": []}\n']:
                s.sendall(payload)
                resp = json.loads(rfile.readline())
                assert resp["ok"] is False and "error" in resp, resp
            s.sendall(b'{"op": "ping"}\n')
            assert json.loads(rfile.readline())["ok"] is True


def test_server_flood_sheds_gracefully():
    raws = [_raw(s) for s in range(4)]
    shed = dataclasses.replace(SERVE, max_pending=2, max_delay_ms=500.0, max_batch=2)
    responses = [None] * 6
    with _server(serve=shed) as server:

        def worker(i):
            with RegistrationClient(server.host, server.port, timeout=600) as c:
                try:
                    responses[i] = c.register(raws[i % 4][0], raws[i % 4][1])
                except RuntimeError as e:
                    responses[i] = {"ok": False, "error": str(e)}

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        st = server.engine.stats()
        with RegistrationClient(server.host, server.port) as c:
            assert c.ping()
    assert all(r is not None for r in responses)
    shed_resps = [r for r in responses if "transformation" not in r]
    for r in shed_resps:
        assert "overloaded" in str(r.get("error", "")).lower(), r
    assert st["shed"] == len(shed_resps) >= 1


def test_server_request_limits():
    with _server(max_line_bytes=65536, max_points=100) as server:
        with socket.create_connection((server.host, server.port), timeout=60) as s:
            rfile = s.makefile("rb")
            s.sendall(b'{"op": "register", "source": {"points": ['
                      + b"[1.0,2.0,3.0]," * 10000 + b"]}}\n")
            resp = json.loads(rfile.readline())
            assert resp["ok"] is False and resp["code"] == "too_large"
            assert rfile.readline() == b""
        with socket.create_connection((server.host, server.port), timeout=60) as s:
            rfile = s.makefile("rb")
            pts = [[0.1 * i, 0.2, 0.3] for i in range(101)]
            req = {"op": "register", "source": {"points": pts}, "target": {"points": pts}}
            s.sendall(json.dumps(req).encode() + b"\n")
            resp = json.loads(rfile.readline())
            assert resp["ok"] is False and "max 100" in resp["error"]
            s.sendall(b'{"op": "ping"}\n')
            assert json.loads(rfile.readline())["ok"] is True


def test_server_path_root(tmp_path):
    served = tmp_path / "served"
    served.mkdir()
    s, t, _ = _raw(0)
    inside, outside = served / "target.ply", tmp_path / "secret.ply"
    write_ply(inside, t.astype(np.float32))
    write_ply(outside, t.astype(np.float32))
    with _server(path_root=served) as server:
        with RegistrationClient(server.host, server.port, timeout=600) as c:
            with pytest.raises(RuntimeError, match="outside the served root"):
                c.register(s, str(outside))
            with pytest.raises(RuntimeError, match="outside the served root"):
                c.register(s, str(served / ".." / "secret.ply"))
            assert c.register(s, str(inside))["fitness"] > 0.0


def test_cloud_cache_invalidates_on_file_change(tmp_path):
    s, t, _ = _raw(0)
    path = tmp_path / "model.ply"
    write_ply(path, t.astype(np.float32))
    with _server() as server:
        with RegistrationClient(server.host, server.port, timeout=600) as c:
            c.register(s, str(path))
            c.register(s, str(path))
            write_ply(path, _raw(1)[1].astype(np.float32))
            st0 = path.stat()
            os.utime(path, ns=(st0.st_atime_ns, st0.st_mtime_ns + 1_000_000))
            c.register(s, str(path))
        assert server.cache.hits == 1 and server.cache.misses == 2


def test_server_close_before_serving():
    server = _server()
    done = threading.Event()

    def closer():
        server.close()
        done.set()

    threading.Thread(target=closer, daemon=True).start()
    assert done.wait(timeout=60), "close() hung without serve_forever()"


def test_server_accepts_payload_exactly_at_limit():
    limit = 4096
    with _server(max_line_bytes=limit, max_points=100) as server:
        with socket.create_connection((server.host, server.port), timeout=60) as s:
            rfile = s.makefile("rb")
            base = {"op": "nope", "pad": ""}
            pad = limit - len(json.dumps(base).encode())
            base["pad"] = "x" * pad
            line = json.dumps(base).encode()
            assert len(line) == limit
            s.sendall(line + b"\n")
            assert json.loads(rfile.readline()).get("code") != "too_large"
            base["pad"] = "x" * (pad + 1)
            line = json.dumps(base).encode()
            assert len(line) == limit + 1
            s.sendall(line + b"\n")
            resp = json.loads(rfile.readline())
            assert resp["ok"] is False and resp["code"] == "too_large"
