"""The port's CUDA graphs (registration/graphs.py): the batch API's graphs
of the fused step, and the ICP loop's, through one device state.

CPU tests run the real device states with the CUDA parts under them (pool,
streams, event, capture) replaced by test doubles.  They hold the cache's
policy: a key's first sighting runs eagerly, its second captures, its
third replays; every field of the key (the lane count, the capacity, each
``_Knobs`` field, the device, the matmul precision) separates graphs, and
host threads share them; at most ``MAX_GRAPHS`` keys are kept, least
recently used dropped first; a mesh, a CPU device and the adaptive budget
always run eagerly; each bucket step counts into exactly one of the three
counters, and only while recording; a capture's kernel launches count at
each replay, not at the capture.  And the ICP loop's (``icp_loop``, its
CUDA check monkeypatched): it captures into the same device state as a
batch step, with the eager loop's answers; its replays add its capture's
launch tally; it moves none of the batch API's counters.

The ``gpu`` tests hold ``register_pairs_batched`` through replays to
``fused_register_step`` called directly, bucket by bucket, bit for bit:
over calls with new bits and new orders, with two buckets replayed in the
reverse of their capture order, a ``PendingBatch`` left unresolved across a
second launch that replays the same graphs, and a bucket whose lane count
changes and so captures a graph of its own; and a replay counts the eager
step's kernel launches.  They skip without a card.

This file imports neither JAX nor tpu3dm; on a card run
``python -m pytest --noconftest tests/test_torch_batch_graphs.py``.
"""

import contextlib
import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu3dm_torch.core.cloud import PointCloud
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration import batch as pbatch
from tpu3dm_torch.registration import graphs
from tpu3dm_torch.registration.fused import fused_register_step
from tpu3dm_torch.utils.profiler import Profiler

COUNTERS = ("batch.eager_steps", "batch.graph_captures", "batch.graph_replays")
CARD = torch.device("cuda", 0)  # a key's device; the CPU tests launch nothing there
KNOBS = pbatch._Knobs.of(None, ransac_iterations=512, icp_iterations=8, icp_solves_per_nn=2,
                         approx_score=True, sample_mode="roll")


@pytest.fixture
def recording():
    Profiler.enable(False)
    Profiler.reset()
    Profiler.enable()
    yield
    Profiler.enable(False)
    Profiler.reset()


def _counts() -> tuple[int, int, int]:
    c = Profiler.counters()
    return tuple(c.get(k, 0) for k in COUNTERS)


class _FakeStream:
    """The test double of a CUDA stream: it lies on the CPU, stands for
    ``card`` and waits on nothing."""

    cuda_stream = 0

    def __init__(self, card=None):
        self.card, self.device = card, torch.device("cpu")

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        event.waits += 1


class _FakeEvent:
    """The test double of the replays' event: its waits and its records."""

    def __init__(self):
        self.waits = self.records = 0

    def record(self, stream=None):
        self.records += 1


class _FakeCudaGraph:
    """The test double of a captured graph: a replay runs the captured
    function on its static inputs and writes what it returns into
    ``outputs``, in place."""

    def __init__(self, fn, args):
        self.fn, self.args, self.outputs, self.replays = fn, args, [], 0

    def replay(self):
        self.outputs[:] = self.fn(*self.args)
        self.replays += 1


class _FakeCuda:
    """The CUDA parts under ``graphs.DeviceGraphs`` (pool, streams, event,
    capture) replaced by test doubles, so that the real device
    states, captures and replays run on the CPU, a card's or not.
    ``captured``: the card index of each capture, which also launches
    ``kernel`` once where one is given (a launch the capture tallies)."""

    def __init__(self, monkeypatch, kernel=None):
        self.captured, self.pools, self.graphs, self.kernel = [], [], [], kernel
        monkeypatch.setattr(graphs, "_DEVICES", {})
        monkeypatch.setattr(graphs, "capture_graph", self.capture)
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
        monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
        monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
        monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)

    def capture(self, fn, args, pool, stream):
        self.captured.append(stream.card.index)
        self.pools.append((pool, stream))
        if self.kernel is not None:
            self.kernel.launch(torch.device("cuda"))
        self.graphs.append(_FakeCudaGraph(fn, args))
        return self.graphs[-1], self.graphs[-1].outputs


def _cache(monkeypatch):
    return graphs.StepGraphs(), _FakeCuda(monkeypatch).captured


def _inputs(b=2, cap=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(b, cap, 3, generator=g), torch.rand(b, cap, 4, generator=g))


class _Step:
    """A step that sums its inputs, and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, a, f):
        self.calls += 1
        return a.sum(dim=(1, 2)), f.sum(dim=(1, 2))


def test_first_sighting_is_eager_second_captures_third_replays(monkeypatch, recording):
    cache, captured = _cache(monkeypatch)
    step = _Step()
    want = [step(*_inputs(seed=s)) for s in range(4)]
    step.calls = 0
    got = []
    for s, counts in zip(range(4), ((1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2))):
        got.append(cache.run(CARD, KNOBS, _inputs(seed=s), step))
        assert _counts() == counts
    assert step.calls == 4 and captured == [0]
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    assert cache.graphs() == 1 and len(cache) == 1
    spans = [sp.name for sp in Profiler.spans()]
    assert spans.count("batch.graph") == 3  # the capture's replay and two more


def _field_variant(name):
    v = getattr(KNOBS, name)
    if isinstance(v, bool):
        return not v
    if isinstance(v, str):
        return "gather" if v == "roll" else "roll"
    return v * 2 + 1


KEY_FIELDS = (["b", "cap", "device", "matmul_precision"]
              + [f.name for f in dataclasses.fields(pbatch._Knobs)])


@pytest.mark.parametrize("field", KEY_FIELDS)
def test_every_field_of_the_key_separates_graphs(monkeypatch, recording, field):
    """A key captured twice over, then the same step with one field changed:
    a first sighting (eager), and the captured key still replays."""
    cache, _ = _cache(monkeypatch)
    step = _Step()
    for _ in range(2):
        cache.run(CARD, KNOBS, _inputs(), step)
    assert _counts() == (1, 1, 0)
    dev, knobs, inputs = CARD, KNOBS, _inputs()
    if field == "b":
        inputs = _inputs(b=3)
    elif field == "cap":
        inputs = _inputs(cap=16)
    elif field == "device":
        dev = torch.device("cuda", 1)
    elif field != "matmul_precision":
        knobs = dataclasses.replace(KNOBS, **{field: _field_variant(field)})
    if field == "matmul_precision":  # TF32 allowed or not
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high" if prev == "highest" else "highest")
        try:
            cache.run(dev, knobs, inputs, step)
        finally:
            torch.set_float32_matmul_precision(prev)
    else:
        cache.run(dev, knobs, inputs, step)
    assert _counts() == (2, 1, 0)
    cache.run(CARD, KNOBS, _inputs(), step)
    assert _counts() == (2, 1, 1)
    assert len(cache) == 2 and cache.graphs() == 1


def _in_thread(fn, *args):
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(out) == 1
    return out[0]


def test_host_threads_share_the_graphs(monkeypatch, recording):
    """A key seen on one thread, captured on a second and replayed on the
    first: the thread is no part of the key."""
    cache, captured = _cache(monkeypatch)
    step = _Step()
    cache.run(CARD, KNOBS, _inputs(seed=0), step)
    assert _counts() == (1, 0, 0)
    got = _in_thread(cache.run, CARD, KNOBS, _inputs(seed=1), step)
    assert _counts() == (1, 1, 0) and captured == [0]
    assert all(torch.equal(x, y) for x, y in zip(got, _Step()(*_inputs(seed=1))))
    cache.run(CARD, KNOBS, _inputs(seed=2), step)
    assert _counts() == (1, 1, 1) and len(cache) == cache.graphs() == 1


def test_threads_at_a_second_sighting_capture_once(monkeypatch, recording):
    """Eight threads reach a key's second sighting together: one captures,
    the others replay its graph, one at a time, each with its own answer."""
    cache, captured = _cache(monkeypatch)
    step = _Step()
    cache.run(CARD, KNOBS, _inputs(seed=0), step)
    barrier = threading.Barrier(8)
    results = {}

    def worker(seed):
        barrier.wait(timeout=30)
        results[seed] = cache.run(CARD, KNOBS, _inputs(seed=seed), step)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(1, 9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert captured == [0] and _counts() == (1, 1, 7)
    for seed, got in results.items():
        assert all(torch.equal(x, y) for x, y in zip(got, _Step()(*_inputs(seed=seed))))


def test_a_capture_tallies_its_launches_for_its_replays(monkeypatch):
    """Inside ``tallied_launches`` a thread's kernel launches go to the tally,
    not to the kernels' counts, while another thread's still count;
    ``add_launch_counts`` adds a tally, as each replay does."""
    from tpu3dm_torch import csrc

    monkeypatch.setattr(csrc, "KERNELS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    k = csrc.Kernel("k", "none.cu", "t3t_none", [])
    j = csrc.Kernel("j", "none.cu", "t3t_none", [])
    for kern in (k, j):
        kern._fn = lambda *args: 0
    card = torch.device("cuda")  # no index: launched as it is, on the current device
    k.launch(card)
    with csrc.tallied_launches() as tally:
        k.launch(card)
        k.launch(card)
        j.launch(card)
        _in_thread(j.launch, card)  # another thread's launch counts
    assert tally == {"k": 2, "j": 1} and (k.launches, j.launches) == (1, 1)
    k.launch(card)
    csrc.add_launch_counts(tally)
    csrc.add_launch_counts(tally)
    assert (k.launches, j.launches) == (6, 3)
    csrc.reset_launch_counts()
    assert (k.launches, j.launches) == (0, 0)


def test_the_cache_keeps_the_least_recently_used_bound(monkeypatch, recording):
    """Keys of 20 capacities, each seen twice, with capacity 1's touched
    again before each new one: at most MAX_GRAPHS keys and graphs held;
    capacity 1's graph survives and replays, capacity 2's was dropped and is
    a first sighting again."""
    cache, captured = _cache(monkeypatch)
    step = _Step()
    for cap in range(1, 21):
        for _ in range(2):
            cache.run(CARD, KNOBS, _inputs(cap=cap), step)
        cache.run(CARD, KNOBS, _inputs(cap=1), step)
        assert len(cache) <= graphs.MAX_GRAPHS and cache.graphs() <= graphs.MAX_GRAPHS
    assert len(cache) == cache.graphs() == graphs.MAX_GRAPHS == 16
    assert len(captured) == 20
    before = _counts()
    cache.run(CARD, KNOBS, _inputs(cap=1), step)
    assert _counts() == (before[0], before[1], before[2] + 1)
    cache.run(CARD, KNOBS, _inputs(cap=2), step)
    assert _counts() == (before[0] + 1, before[1], before[2] + 1)


# --- the ICP loop's graphs: the same device state ---------------------------

ICP_KW = dict(dist_thresh=0.2, max_iterations=6, relative_fitness=-1.0, relative_rmse=-1.0)
ICP_REPLAYS = ICP_KW["max_iterations"] - 1  # iteration 0 runs eagerly


def _icp(monkeypatch, cuda_graph):
    """``icp_refine`` on the CPU of a 200-point pair moved apart, every
    iteration of its budget taken; its graphs are card 0's (the loop's CUDA
    check monkeypatched)."""
    from tpu3dm_torch.registration import icp

    monkeypatch.setattr(icp, "device_graphs", lambda dev: graphs.device_graphs(CARD))
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(200, 3, generator=g)
    normals = torch.nn.functional.normalize(torch.rand(200, 3, generator=g) - 0.5, dim=-1)
    mask, none = torch.ones(200, dtype=torch.bool), torch.zeros(200, 0)
    src = PointCloud(points=pts, mask=mask, normals=normals, features=none)
    tgt = PointCloud(points=pts + 0.01 * torch.randn(200, 3, generator=g) + 0.02, mask=mask,
                     normals=normals, features=none)
    res = icp.icp_refine(src, tgt, torch.eye(4), cuda_graph=cuda_graph, **ICP_KW)
    return [res.transformation, res.fitness, res.inlier_rmse, torch.as_tensor(res.iterations)]


def test_icp_and_the_batch_step_share_one_device_state(monkeypatch):
    """A batch step captured on card 0 and an ICP loop there: both captured
    into card 0's one pool on its one stream, both replays waited on and
    recorded its one event; the loop's answers are the eager loop's."""
    fake = _FakeCuda(monkeypatch)
    eager = _icp(monkeypatch, False)
    assert fake.captured == []
    cache, step = graphs.StepGraphs(), _Step()
    for _ in range(2):
        cache.run(CARD, KNOBS, _inputs(), step)
    got = _icp(monkeypatch, True)
    state = graphs.device_graphs(CARD)
    assert list(graphs._DEVICES.values()) == [state]
    assert fake.captured == [0, 0] and fake.pools == [(state.pool, state.stream)] * 2
    assert state.done.waits == state.done.records == 1 + ICP_REPLAYS
    assert [g.replays for g in fake.graphs] == [1, ICP_REPLAYS]
    assert all(torch.equal(x, y) for x, y in zip(got, eager))


def test_an_icp_replay_adds_its_capture_launch_tally(monkeypatch):
    """The ICP loop's capture launches a kernel once: the launch is tallied,
    not counted, and each replay through the device state adds it."""
    from tpu3dm_torch import csrc

    monkeypatch.setattr(csrc, "KERNELS", {})
    k = csrc.Kernel("k", "none.cu", "t3t_none", [])
    k._fn = lambda *args: 0
    fake = _FakeCuda(monkeypatch, kernel=k)
    _icp(monkeypatch, True)
    assert fake.captured == [0] and k.launches == ICP_REPLAYS


def test_icp_graphs_move_no_batch_counter(monkeypatch, recording):
    """The ICP loop's capture and replays count into no ``batch.*`` counter
    and enter no ``batch.graph`` span; a batch step's three sightings after
    them count as before."""
    fake = _FakeCuda(monkeypatch)
    _icp(monkeypatch, True)
    assert fake.captured == [0] and Profiler.counters() == {}
    assert not any(sp.name.startswith("batch.") for sp in Profiler.spans())
    cache, step = graphs.StepGraphs(), _Step()
    for _ in range(3):
        cache.run(CARD, KNOBS, _inputs(), step)
    assert _counts() == (1, 1, 1)
    assert [sp.name for sp in Profiler.spans()].count("batch.graph") == 2


def _cloud(n_valid, cap=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    mask = torch.arange(cap) < n_valid
    return ProcessedCloud(full=None, voxel_size=0.3, down=PointCloud(
        points=torch.rand(cap, 3, generator=g), mask=mask,
        normals=torch.rand(cap, 3, generator=g), features=torch.rand(cap, 33, generator=g)))


def _stub_step(src_pts, *args, **kw):
    b = src_pts.shape[0]
    return torch.eye(4).expand(b, 4, 4), torch.zeros(b), torch.zeros(b)


class _NoGraphs:
    def run(self, *args):
        raise AssertionError("this step must run eagerly")


@pytest.mark.parametrize("case", ["cpu", "mesh", "adaptive_budget"])
def test_mesh_cpu_and_the_adaptive_budget_run_eagerly(monkeypatch, recording, case):
    """``_Knobs.step`` never reaches the graph cache on the CPU, on a mesh or
    with ``adapt_iterations`` > 0 (on a card device too); a card step
    without them does."""
    from tpu3dm_torch.parallel import mesh as pmesh

    calls = []
    monkeypatch.setattr(pbatch, "fused_register_step",
                        lambda *a, **kw: calls.append("fused") or _stub_step(*a, **kw))
    monkeypatch.setattr(pbatch, "batched_register",
                        lambda m, *a, **kw: calls.append("mesh") or _stub_step(*a, **kw))
    monkeypatch.setattr(pbatch, "_STEP_GRAPHS", _NoGraphs())
    src = tuple(torch.zeros((4, 64) + s) for s in ((3,), (33,), ()))
    tgt = tuple(torch.zeros((4, 64) + s) for s in ((3,), (33,), (), (3,)))
    bits = torch.zeros((4, 1, 256), dtype=torch.int64)
    knobs, dev, mesh = KNOBS, CARD, None
    if case == "cpu":
        dev = torch.device("cpu")
    elif case == "mesh":
        dev, mesh = torch.device("cpu"), pmesh.make_mesh(4, 1, devices=[torch.device("cpu")] * 4)
    else:
        knobs = dataclasses.replace(KNOBS, adapt_iterations=4096)
    knobs.step(src, tgt, bits, None, dev, mesh)
    assert calls == ["mesh" if case == "mesh" else "fused"] and _counts() == (1, 0, 0)

    seen = []
    monkeypatch.setattr(pbatch, "_STEP_GRAPHS", type("Spy", (), {
        "run": lambda self, d, k, inputs, step: seen.append((d, k, len(inputs))) or "replayed"}
    )())
    assert KNOBS.step(src, tgt, bits, None, CARD, None) == "replayed"
    assert seen == [(CARD, KNOBS, 8)]


def test_each_bucket_step_counts_once_and_only_while_recording(monkeypatch):
    """Three buckets a call on the CPU: three eager steps while recording,
    no counter at all while not; through the cache, one count a step."""
    monkeypatch.setattr(pbatch, "fused_register_step", _stub_step)
    pairs = [(_cloud(n, seed=i), _cloud(n, seed=i + 9)) for i, n in enumerate((10, 40, 60, 12))]
    kw = dict(bucket_multiple=16, ransac_iterations=512, device="cpu")
    Profiler.enable(False)
    Profiler.reset()
    try:
        res = pbatch.register_pairs_batched(pairs, None, **kw)
        assert sorted(set(res.bucket_of_pair)) == [16, 48, 64]
        assert Profiler.counters() == {} and Profiler.spans() == []
        Profiler.enable()
        pbatch.register_pairs_batched(pairs, None, **kw)
        assert _counts() == (3, 0, 0)
        assert Profiler.counters()["batch.pairs"] == 4

        cache, _ = _cache(monkeypatch)
        step = _Step()
        for _ in range(3):
            cache.run(CARD, KNOBS, _inputs(), step)
        assert _counts() == (4, 1, 1)
        Profiler.enable(False)
        cache.run(CARD, KNOBS, _inputs(), step)
        assert _counts() == (4, 1, 1)
    finally:
        Profiler.enable(False)
        Profiler.reset()


# --- on a card ------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def card_pairs():
    """Scan pairs of the benchmark's generator, preprocessed on the card with
    the ``scan20k`` settings: (pairs, pipeline config, cell knobs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the card tests run there with --noconftest")
    from perfbench.lib import program, synthetic
    from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "perfbench" / "configs" / "scan20k.json").read_text())
    pipeline = program.pipeline_config(cfg)
    clouds = []
    for seed, (n, points) in enumerate(((6, 6000), (6, 20000))):
        src, tgt, _ = synthetic.make_pairs("scan", n, points,
                                           synthetic.generator(seed + 5, 0, dev))
        clouds += list(zip(src.cpu().numpy(), tgt.cpu().numpy()))
    procs = preprocess_points_batch([x for pair in clouds for x in pair], pipeline.preprocess,
                                    full_normals=False, device=dev)
    pairs = [(procs[2 * i], procs[2 * i + 1]) for i in range(len(clouds))]
    kw = dict(bucket_multiple=cfg["bucket_multiple"], ransac_iterations=cfg["ransac_iterations"],
              icp_iterations=cfg["icp_iterations"], icp_solves_per_nn=cfg["icp_solves_per_nn"],
              approx_score=cfg["approx_score"], rescue_restarts=cfg["rescue_restarts"],
              device=dev)
    return pairs, pipeline, kw


def _spy_steps(monkeypatch):
    """Every bucket step's knobs, inputs (cloned) and outputs, in order."""
    seen = []
    real = pbatch._Knobs.step

    def step(self, src, tgt, bits, extra, dev, mesh=None):
        inputs = tuple(x.clone() for x in (*src, *tgt, bits))
        out = real(self, src, tgt, bits, extra, dev, mesh)
        seen.append((self, dev, inputs, out))
        return out

    monkeypatch.setattr(pbatch._Knobs, "step", step)
    return seen


def _eager(knobs, dev, x):
    """``fused_register_step`` called directly on a recorded step's inputs."""
    return fused_register_step(*x[:3], None, *x[3:7], x[7], device=dev,
                               ransac_batch=min(knobs.ransac_iterations, 4096),
                               **dataclasses.asdict(knobs))


def _assert_steps_are_the_eager_step(seen):
    """Each recorded step's outputs equal ``fused_register_step`` called
    directly on its inputs, bit for bit."""
    for knobs, dev, x, out in seen:
        want = _eager(knobs, dev, x)
        for got, w in zip(out, want):
            assert got.dtype == w.dtype and torch.equal(got, w)


def _assert_result_is(res, seen_part):
    """The BatchResult's rows equal the recorded steps' outputs, bucket by
    bucket (lanes in input order within a bucket)."""
    caps = sorted(set(res.bucket_of_pair))
    assert len(caps) == len(seen_part)
    for cap, (_, _, _, (T, fit, rmse)) in zip(caps, seen_part):
        rows = [i for i, c in enumerate(res.bucket_of_pair) if c == cap]
        np.testing.assert_array_equal(res.transforms[rows], T.cpu().numpy())
        np.testing.assert_array_equal(res.ransac_fitness[rows], fit.cpu().numpy())
        np.testing.assert_array_equal(res.icp_rmse[rows], rmse.cpu().numpy())


@pytest.mark.gpu
def test_replays_equal_the_eager_step_bit_for_bit(card_pairs, monkeypatch, recording):
    pairs, pipeline, kw = card_pairs
    probe = pbatch.register_pairs_batched(pairs, pipeline, **kw)
    caps = sorted(set(probe.bucket_of_pair))
    assert len(caps) >= 2, caps
    A = [i for i, c in enumerate(probe.bucket_of_pair) if c == caps[0]]  # the smallest
    B = [i for i, c in enumerate(probe.bucket_of_pair) if c == caps[-1]]  # the largest
    monkeypatch.setattr(pbatch, "_STEP_GRAPHS", graphs.StepGraphs())
    seen = _spy_steps(monkeypatch)
    Profiler.reset()
    rng = np.random.default_rng(3)

    def launch(idx, seed):
        order = [int(i) for i in rng.permutation(idx)]
        pending = pbatch.launch_pairs_batched([pairs[i] for i in order], pipeline,
                                              generator=torch.Generator().manual_seed(seed),
                                              **kw)
        return order, pending

    def call(idx, seed, counts):
        start = len(seen)
        _, pending = launch(idx, seed)
        res = pending.resolve()
        _assert_result_is(res, seen[start:])
        assert _counts() == counts, seed

    call(B, 1, (1, 0, 0))
    call(B, 2, (1, 1, 0))  # B captured first
    call(A, 3, (2, 1, 0))
    call(A, 4, (2, 2, 0))  # then A
    call(A + B, 5, (2, 2, 2))  # replayed A, then B: the reverse of their capture order
    start = len(seen)
    _, p1 = launch(A + B, 6)
    _, p2 = launch(B + A, 7)  # replays the same graphs before p1 is resolved
    r2, r1 = p2.resolve(), p1.resolve()
    _assert_result_is(r1, seen[start:start + 2])
    _assert_result_is(r2, seen[start + 2:start + 4])
    assert _counts() == (2, 2, 6)
    A2 = A[:-1]  # one lane fewer: a key of its own
    call(A2 + B, 8, (3, 2, 7))
    call(A2 + B, 9, (3, 3, 8))
    call(A2 + B, 10, (3, 3, 10))
    assert pbatch._STEP_GRAPHS.graphs() == 3
    spans = [sp.name for sp in Profiler.spans()]
    assert spans.count("batch.graph") == 3 + 10  # every replay, a capture's too
    _assert_steps_are_the_eager_step(seen)

    # A replay counts the kernel launches of the eager step it stands for.
    from tpu3dm_torch.csrc import KERNELS, reset_launch_counts

    knobs, dev, x, _ = seen[-1]
    reset_launch_counts()
    knobs.step(x[:3], x[3:7], x[7], None, dev)
    torch.cuda.synchronize()
    replayed = {n: k.launches for n, k in KERNELS.items()}
    reset_launch_counts()
    _eager(knobs, dev, x)
    eager = {n: k.launches for n, k in KERNELS.items()}
    assert _counts() == (3, 3, 11) and replayed == eager and sum(eager.values()) > 0, eager
