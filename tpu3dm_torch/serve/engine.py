"""Request-batching registration serving engine (port of tpu3dm/serve/engine.py).

Callers ``submit()`` preprocessed pairs from any thread and get a
``Future[PairResult]``; past ``max_pending`` requests in flight the engine
sheds load by raising ``EngineOverloaded``.  One dispatcher thread collects
requests for at most ``max_delay_ms`` after the first (or until
``max_batch``), partitions them by target identity, and launches them
through the batch API (registration/batch.py): requests that share a target
cloud object go through a device-resident ``ResidentTarget``
(``launch_sources_to_target``), the rest through ``launch_pairs_batched``.
A resolver thread (``pipeline_depth=1``) or the dispatcher itself (0)
copies each micro-batch's outputs to the host and resolves the futures.

Randomness: request ``seq`` (its sequence number) takes the RANSAC bits
``request_bits(seq, cap, knobs)`` at its own bucket capacity, drawn from a
CPU generator seeded by one splitmix64 round of ``seq`` (JAX's
``_request_key`` round).  A pair's capacity depends on the pair alone and
the fused step's sums do not depend on the batch (ops/rowsum.py), so a
request's result is the same bits whichever micro-batch it lands in.

Departures from JAX, each forced by eager PyTorch on one card:
  - The batch API's launch returns after the fused step's host syncs, so
    ``pipeline_depth=1`` overlaps only the next micro-batch's host pack with
    this one's device tail and copy-out.
  - ``prewarm`` has no compile to pay: it builds the kernels (csrc) and runs
    each (capacity, batch, route) shape once.
  - ``fence_uploads`` synchronizes the engine's CUDA stream.

With a ``mesh`` every micro-batch goes through ``launch_pairs_batched(mesh=
...)`` (pair-sharded, parallel/register.py) and the resident-target route
is skipped, as in JAX.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core.cloud import PointCloud, round_up
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.parallel.mesh import check_mesh
from tpu3dm_torch.parallel.multipair import draw_bits
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration import batch as _batch
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)

_STOP = object()


class EngineOverloaded(RuntimeError):
    """Raised by ``submit`` when the in-flight request count reaches
    ``ServeConfig.max_pending``: explicit load shedding instead of an
    unbounded queue (callers back off and retry)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Micro-batching and per-request work knobs (JAX's fields and defaults)."""

    max_batch: int = 256  # pairs per micro-batch (memory / latency bound)
    max_delay_ms: float = 5.0  # linger after the first request of a group
    bucket_multiple: int = 256  # capacity quantum (registration/batch.py)
    ransac_iterations: int = 4096
    icp_iterations: int = 8
    icp_solves_per_nn: int = 2
    approx_score: bool = True
    rescue_restarts: int = 0
    sample_mode: str = "roll"
    # Requests whose target is the SAME ProcessedCloud object, at least
    # target_resident_min of them in a micro-batch, run against a
    # device-resident target (register_sources_to_target).  0 disables.
    target_resident_min: int = 2
    # At most resident_targets_max targets stay uploaded (LRU), each with at
    # most resident_caps_max capacity variants (ResidentTarget's LRU).
    resident_targets_max: int = 32
    resident_caps_max: int = 8
    # submit() raises EngineOverloaded once this many requests are in
    # flight (submitted, not yet resolved).  0 = unbounded.
    max_pending: int = 1024
    # Synchronize the engine's CUDA stream after the launches, so pack_ms
    # holds every queued upload and kernel and device_ms the copy-out only.
    fence_uploads: bool = False
    # 1: the dispatcher hands launched micro-batches to a resolver thread,
    # overlapping batch i+1's host pack with batch i's copy-out.  0: resolve
    # inline.  Both are measured on the card (PERF.md, path V).
    pipeline_depth: int = 0


@dataclasses.dataclass
class PairResult:
    """Resolved value of one registration request: ``latency_ms`` =
    ``queue_ms + pack_ms + device_ms`` up to scheduler jitter."""

    transformation: np.ndarray  # [4, 4] target <- source
    fitness: float  # RANSAC inlier fitness
    inlier_rmse: float  # final ICP rmse
    bucket: int  # capacity bucket the pair ran at
    latency_ms: float  # submit -> resolve wall time
    queue_ms: float = 0.0  # submit -> micro-batch dispatch start
    pack_ms: float = 0.0  # host pack + launches (batch-level)
    device_ms: float = 0.0  # launch return -> outputs on the host (batch-level)


@dataclasses.dataclass
class _Pending:
    src: ProcessedCloud
    tgt: ProcessedCloud
    seq: int  # request sequence number: its RANSAC bits
    future: Future
    t_submit: float


def _splitmix64(seq: int) -> int:
    """One splitmix64 round of ``seq`` (JAX's ``_request_key`` round, as one
    64-bit value)."""
    mask = (1 << 64) - 1
    z = (seq + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def request_bits(seq: int, cap: int, knobs) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Request ``seq``'s (sample_bits, extra_bits) at bucket capacity
    ``cap``, in ``batch.pair_bits_shape``'s layout for the engine's
    ``knobs`` (extra_bits None without the adaptive budget), drawn on the
    CPU from a generator seeded by one splitmix64 round of ``seq``.  The
    bits depend on the request and its capacity alone."""
    gen = torch.Generator().manual_seed(_splitmix64(seq))
    shape, extra_shape = knobs.bits_shape(cap)
    return draw_bits(shape, gen), (None if extra_shape is None else draw_bits(extra_shape, gen))


def _synthetic_processed(n_valid: int, device: torch.device) -> ProcessedCloud:
    """A ProcessedCloud with exactly ``n_valid`` valid down points, whose
    bucket is round_up(n_valid, multiple): prewarm fodder."""
    rng = np.random.default_rng(n_valid)
    pts = rng.normal(size=(n_valid, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_valid, 3)).astype(np.float32)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    feat = rng.random(size=(n_valid, 33)).astype(np.float32)
    down = PointCloud(
        points=torch.from_numpy(pts).to(device),
        mask=torch.ones((n_valid,), dtype=torch.bool, device=device),
        normals=torch.from_numpy(nrm).to(device),
        features=torch.from_numpy(feat).to(device),
    )
    return ProcessedCloud(full=down, down=down, voxel_size=0.3)


class ServeEngine:
    """Thread-safe micro-batching front of the batched registration path.

    Lifecycle: construct, ``submit()`` / ``register()`` from any number of
    threads, ``close()`` once (drains in-flight requests).  Also a context
    manager.  ``device=None`` means CUDA and raises without it; the
    requests are packed there.  ``mesh``: a ``parallel.mesh.Mesh`` whose
    pair axis every micro-batch is split over.
    """

    def __init__(
        self,
        pipeline: PipelineConfig | None = None,
        serve: ServeConfig = ServeConfig(),
        *,
        mesh=None,
        device=None,
    ) -> None:
        if mesh is not None:
            check_mesh("ServeEngine", mesh)
        self.device = resolve_device(device)
        self.pipeline = pipeline or PipelineConfig.with_voxel_size(0.3)
        self.serve = serve
        self.mesh = mesh
        self._knobs = _batch._Knobs.of(
            self.pipeline, rescue_restarts=serve.rescue_restarts,
            ransac_iterations=serve.ransac_iterations, icp_iterations=serve.icp_iterations,
            icp_solves_per_nn=serve.icp_solves_per_nn, approx_score=serve.approx_score,
            sample_mode=serve.sample_mode)
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        # stats (guarded by _lock)
        self._n_requests = 0
        self._n_batches = 0
        self._n_errors = 0
        self._n_shed = 0  # submits rejected by the max_pending bound
        self._n_inflight = 0  # submitted, not yet resolved or failed
        self._n_shared_target = 0  # requests served on the resident route
        self._batch_size_sum = 0
        self._batch_size_max = 0
        self._bucket_counts: dict[int, int] = {}
        self._latencies_ms: deque = deque(maxlen=1024)
        self._queue_ms: deque = deque(maxlen=1024)
        self._pack_ms: deque = deque(maxlen=1024)  # per batch
        self._device_ms: deque = deque(maxlen=1024)  # per batch
        # id(target cloud) -> (cloud, ResidentTarget), LRU-ordered; the
        # cloud reference pins the id so it cannot be recycled.
        self._residents: OrderedDict[int, tuple] = OrderedDict()
        # Depth-1 handoff between the dispatcher (pack + launch) and the
        # resolver (copy-out + futures).
        self._launched_q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._loop, name="tpu3dm-torch-serve-dispatch",
                                        daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          name="tpu3dm-torch-serve-resolve", daemon=True)
        self._thread.start()
        self._resolver.start()

    # -- public API ---------------------------------------------------------

    def submit(self, src: ProcessedCloud, tgt: ProcessedCloud) -> Future:
        """Enqueue one pair; returns a ``Future[PairResult]``.  Raises
        ``EngineOverloaded`` when ``max_pending`` requests are in flight."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ServeEngine is closed")
            limit = self.serve.max_pending
            if limit > 0 and self._n_inflight >= limit:
                self._n_shed += 1
                raise EngineOverloaded(
                    f"{self._n_inflight} requests in flight (max_pending={limit})")
            seq = self._seq
            self._seq += 1
            self._n_requests += 1
            self._n_inflight += 1
            item = _Pending(src, tgt, seq, Future(), time.monotonic())
            # Enqueue under the lock: a concurrent close() must not drain
            # and stop the dispatcher between the check and the put.
            self._q.put(item)
        return item.future

    def register(self, src: ProcessedCloud, tgt: ProcessedCloud, *,
                 timeout: float | None = None) -> PairResult:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(src, tgt).result(timeout)

    def register_points(self, src_points: np.ndarray, tgt_points: np.ndarray, *,
                        timeout: float | None = None) -> PairResult:
        """Preprocess two raw clouds on the engine's device (the down-cloud
        route, no full-resolution normals) and register them."""
        from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

        procs = preprocess_points_batch(
            [np.asarray(src_points), np.asarray(tgt_points)], self.pipeline.preprocess,
            full_normals=False, device=self.device)
        return self.register(procs[0], procs[1], timeout=timeout)

    def stats(self) -> dict:
        """Counters and latency percentiles."""

        def pct(d: deque) -> dict | None:
            a = np.asarray(d, np.float64)
            if not a.size:
                return None
            return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95)), "max": float(a.max())}

        with self._lock:
            n_b = self._n_batches
            out = {
                "requests": self._n_requests,
                "batches": n_b,
                "errors": self._n_errors,
                "shed": self._n_shed,
                "inflight": self._n_inflight,
                "pending": self._q.qsize(),
                "mean_batch_size": (self._batch_size_sum / n_b) if n_b else 0.0,
                "max_batch_size": self._batch_size_max,
                "shared_target_requests": self._n_shared_target,
                "resident_targets": len(self._residents),
                "buckets": dict(sorted(self._bucket_counts.items())),
            }
            comps = {
                "latency_ms": pct(self._latencies_ms),
                "queue_ms": pct(self._queue_ms),
                "pack_ms_per_batch": pct(self._pack_ms),
                "device_ms_per_batch": pct(self._device_ms),
            }
        out.update({k: v for k, v in comps.items() if v is not None})
        return out

    def reset_latency_window(self) -> None:
        """Drop the latency samples so far (after a warm-up window)."""
        with self._lock:
            self._latencies_ms.clear()
            self._queue_ms.clear()
            self._pack_ms.clear()
            self._device_ms.clear()

    def prewarm(self, caps: list[int] | None = None, batch_sizes: list[int] | None = None, *,
                shared_target: bool = True, parallel: int = 4) -> float:
        """Build the kernels and run each (cap, batch size, route) shape once
        before traffic arrives, through the launch functions the dispatcher
        uses, so the first request pays no build or first-use cost.

        Defaults: one bucket (``bucket_multiple``) at ``max_batch`` pairs.
        ``parallel`` > 1 runs the shapes from a thread pool (the kernels'
        first builds and loads share csrc's build lock).  The request
        sequence is untouched, so results do not change.  Returns the wall
        seconds spent.
        """
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from tpu3dm_torch.csrc import build

            build()
        s = self.serve
        caps = caps or [s.bucket_multiple]
        batch_sizes = batch_sizes or [s.max_batch]
        kw = self._launch_kwargs()
        thunks = []
        for cap in caps:
            cloud = _synthetic_processed(cap, self.device)
            for b in batch_sizes:
                bits = [request_bits(i, round_up(cap, s.bucket_multiple), self._knobs)
                        for i in range(b)]

                def pair_thunk(cloud=cloud, b=b, bits=bits):
                    _batch.launch_pairs_batched(
                        [(cloud, cloud)] * b, self.pipeline, device=self.device,
                        mesh=self.mesh, **self._bits_kwargs(bits), **kw).resolve()

                thunks.append(pair_thunk)
                if shared_target and s.target_resident_min > 0 and self.mesh is None:

                    def shared_thunk(cloud=cloud, b=b, bits=bits):
                        rt = _batch.ResidentTarget(cloud, max_caps=s.resident_caps_max,
                                                   device=self.device)
                        _batch.launch_sources_to_target(
                            [cloud] * b, rt, self.pipeline, **self._bits_kwargs(bits),
                            **kw).resolve()

                    thunks.append(shared_thunk)
        if parallel > 1 and len(thunks) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(parallel, len(thunks))) as ex:
                for f in [ex.submit(t) for t in thunks]:
                    f.result()
        else:
            for t in thunks:
                t()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.monotonic() - t0
        logger.info("prewarm: caps=%s batch_sizes=%s parallel=%d in %.1fs",
                    caps, batch_sizes, parallel, dt)
        return dt

    def close(self, *, timeout: float | None = None) -> None:
        """Stop accepting requests, drain the queue, join both threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(_STOP)
        self._thread.join(timeout)
        self._resolver.join(timeout)

    def __enter__(self) -> ServeEngine:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher ---------------------------------------------------------

    def _launch_kwargs(self) -> dict:
        s = self.serve
        return dict(bucket_multiple=s.bucket_multiple, ransac_iterations=s.ransac_iterations,
                    icp_iterations=s.icp_iterations, icp_solves_per_nn=s.icp_solves_per_nn,
                    approx_score=s.approx_score, rescue_restarts=s.rescue_restarts,
                    sample_mode=s.sample_mode)

    @staticmethod
    def _bits_kwargs(bits: list[tuple]) -> dict:
        extra = None if bits[0][1] is None else [x[1] for x in bits]
        return dict(pair_bits=[x[0] for x in bits], pair_extra_bits=extra)

    def _collect(self) -> tuple[list[_Pending], bool]:
        """Block for the first request, then linger up to ``max_delay_ms``."""
        first = self._q.get()
        if first is _STOP:
            return [], True
        batch = [first]
        stopping = False
        deadline = time.monotonic() + self.serve.max_delay_ms / 1000.0
        while len(batch) < self.serve.max_batch:
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            try:
                nxt = self._q.get(timeout=remain)
            except queue.Empty:
                break
            if nxt is _STOP:
                stopping = True
                break
            batch.append(nxt)
        return batch, stopping

    def _drain(self) -> list[_Pending]:
        out = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return out
            if item is not _STOP:
                out.append(item)

    def _loop(self) -> None:
        """Dispatcher: collect -> pack -> launch."""
        while True:
            batch, stopping = self._collect()
            if batch:
                self._launch(batch)
            if stopping:
                final = self._drain()
                if final:
                    self._launch(final)
                self._launched_q.put(_STOP)
                return

    def _resolve_loop(self) -> None:
        """Resolver (depth 1): resolve each launched micro-batch while the
        dispatcher packs the next one."""
        while True:
            item = self._launched_q.get()
            if item is _STOP:
                return
            self._resolve(item)

    def _resident(self, cloud: ProcessedCloud) -> _batch.ResidentTarget:
        """ResidentTarget of a target cloud, cached by object identity (the
        entry pins the cloud so its id cannot be recycled).  A hit moves to
        the end; eviction drops the least recently used."""
        tid = id(cloud)
        ent = self._residents.get(tid)
        if ent is None:
            while len(self._residents) >= max(1, self.serve.resident_targets_max):
                self._residents.popitem(last=False)
            ent = (cloud, _batch.ResidentTarget(cloud, max_caps=self.serve.resident_caps_max,
                                                device=self.device))
        self._residents[tid] = ent
        self._residents.move_to_end(tid)
        return ent[1]

    def _caps(self, batch: list[_Pending]) -> list[int]:
        """Each request's bucket capacity, as the batch API computes it,
        from one host read of every distinct cloud's valid count."""
        clouds = {id(c): c for p in batch for c in (p.src, p.tgt)}
        counts = torch.stack([c.down.mask.sum().to(self.device)
                              for c in clouds.values()]).tolist()
        n = dict(zip(clouds, counts))
        return [round_up(max(n[id(p.src)], n[id(p.tgt)], 1), self.serve.bucket_multiple)
                for p in batch]

    def _fail_batch(self, batch: list[_Pending], e: BaseException) -> None:
        with self._lock:
            self._n_errors += len(batch)
            self._n_inflight -= len(batch)
        for p in batch:
            if p.future.set_running_or_notify_cancel():
                p.future.set_exception(e)

    def _launch(self, batch: list[_Pending]) -> None:
        """Pack and launch the micro-batch; resolve it inline (depth 0) or
        hand it to the resolver (depth 1).  Every error goes to the batch's
        futures: the dispatcher thread must never die."""
        s = self.serve
        t_start = time.monotonic()
        try:
            shared: list[tuple[list[int], _batch.ResidentTarget]] = []
            rest = list(range(len(batch)))
            if s.target_resident_min > 0 and self.mesh is None:
                by_tgt: dict[int, list[int]] = {}
                for pos, p in enumerate(batch):
                    by_tgt.setdefault(id(p.tgt), []).append(pos)
                rest = []
                for poss in by_tgt.values():
                    if len(poss) >= s.target_resident_min:
                        shared.append((poss, self._resident(batch[poss[0]].tgt)))
                    else:
                        rest.extend(poss)
                rest.sort()
            caps = self._caps(batch)

            def bits(poss):
                return self._bits_kwargs(
                    [request_bits(batch[i].seq, caps[i], self._knobs) for i in poss])

            kw = self._launch_kwargs()
            pendings = []  # (positions, PendingBatch)
            for poss, rt in shared:
                pendings.append((poss, _batch.launch_sources_to_target(
                    [batch[i].src for i in poss], rt, self.pipeline, **bits(poss), **kw)))
            if rest:
                pendings.append((rest, _batch.launch_pairs_batched(
                    [(batch[i].src, batch[i].tgt) for i in rest], self.pipeline,
                    device=self.device, mesh=self.mesh, **bits(rest), **kw)))
            if s.fence_uploads and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        except Exception as e:  # noqa: BLE001 - forwarded to the callers' futures
            logger.exception("micro-batch of %d failed at launch", len(batch))
            self._fail_batch(batch, e)
            return
        pack_ms = (time.monotonic() - t_start) * 1e3
        n_shared = sum(len(poss) for poss, _ in shared)
        item = (batch, pendings, n_shared, t_start, pack_ms)
        if s.pipeline_depth == 0:
            self._resolve(item)
        else:
            self._launched_q.put(item)

    def _resolve(self, item: tuple) -> None:
        batch, pendings, n_shared, t_start, pack_ms = item
        results: list = [None] * len(batch)  # (T, fit, rmse, bucket)
        t0 = time.monotonic()
        try:
            for poss, pending in pendings:
                res = pending.resolve()
                for j, i in enumerate(poss):
                    results[i] = (res.transforms[j], res.ransac_fitness[j], res.icp_rmse[j],
                                  res.bucket_of_pair[j])
        except Exception as e:  # noqa: BLE001 - forwarded to the callers' futures
            logger.exception("micro-batch of %d failed at resolve", len(batch))
            self._fail_batch(batch, e)
            return
        now = time.monotonic()
        device_ms = (now - t0) * 1e3
        lats, qwaits = [], []
        for i, p in enumerate(batch):
            T, fit, rmse, bucket = results[i]
            lat_ms = (now - p.t_submit) * 1e3
            queue_ms = (t_start - p.t_submit) * 1e3
            lats.append(lat_ms)
            qwaits.append(queue_ms)
            if not p.future.set_running_or_notify_cancel():
                continue
            p.future.set_result(PairResult(
                transformation=T, fitness=float(fit), inlier_rmse=float(rmse), bucket=bucket,
                latency_ms=lat_ms, queue_ms=queue_ms, pack_ms=pack_ms, device_ms=device_ms))
        with self._lock:
            self._n_batches += 1
            self._n_inflight -= len(batch)
            self._n_shared_target += n_shared
            self._batch_size_sum += len(batch)
            self._batch_size_max = max(self._batch_size_max, len(batch))
            for _, _, _, cap in results:
                self._bucket_counts[cap] = self._bucket_counts.get(cap, 0) + 1
            self._latencies_ms.extend(lats)
            self._queue_ms.extend(qwaits)
            self._pack_ms.append(pack_ms)
            self._device_ms.append(device_ms)
