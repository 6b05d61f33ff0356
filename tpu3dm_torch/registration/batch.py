"""Capacity-bucketed multi-pair registration, the production batch API (port
of tpu3dm/registration/batch.py).

Stacking a mixed-size workload pads every pair to the largest capacity of
the batch, so a few large pairs drag every small one to their NN work.  The
batch API instead

  1. takes each preprocessed cloud's valid rows (one host count a cloud),
  2. groups the pairs into capacity buckets (round_up to ``bucket_multiple``
     of the larger cloud of the pair),
  3. runs each bucket as one ``fused_register_step`` call, with the knobs
     JAX's ``_batched_step`` passes (``ransac_batch=min(iterations, 4096)``,
     ``approx_features=False``, the default ``nn_impl="values_pk"``),
  4. returns per-pair results in input order (``PendingBatch.resolve``),
     writing checkpoint records and restoring the pairs a store already
     holds without dispatching them.

``register_sources_to_target`` registers many sources against ONE target
kept on the device per bucket capacity (``ResidentTarget``), with the same
per-pair results as the pair-batched call for the same bits.

Randomness: JAX folds per-pair keys from ``key`` (or takes ``pair_keys``).
Here each pair takes its own RANSAC bits in ``fused_register_step``'s
``sample_bits`` layout for one lane (``pair_bits_shape``): ``pair_bits``
(and ``pair_extra_bits`` with the adaptive budget), a [P, ...] tensor or a
sequence of P tensors, sliced per bucket; or drawn pair after pair in input
order from ``generator`` (a generator seeded 0 when None, as JAX's default
key is PRNGKey(0)).  A pair's bits therefore never depend on its bucket or
on the window a streaming caller cuts, as JAX guarantees with its keys.

With a ``mesh`` (parallel/mesh.py) each bucket goes through
``parallel.register.batched_register``: its pair axis is padded to a
multiple of the mesh's pair axis with repeats of its first pair and that
pair's bits (JAX's quantum pad), split over the mesh, and the padded lanes
dropped; a pair's result is the same bits as without the mesh.

One deliberate departure from JAX: no power-of-two padding of a bucket's
pair axis.  JAX pads it so that repeated calls reuse a few compiled
programs; eager PyTorch compiles nothing, so a bucket runs its pairs and
at most the mesh's quantum of repeats.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.core.cloud import round_up
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.multiway.checkpoint import EdgeRecord
from tpu3dm_torch.parallel.mesh import PAIR_AXIS, check_mesh
from tpu3dm_torch.parallel.multipair import chunk_bits_shape, draw_bits, extra_chunk_count
from tpu3dm_torch.parallel.register import batched_register
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.registration.fused import fused_register_step


@dataclasses.dataclass
class BatchResult:
    """Per-pair outputs of a batched registration, in input order."""

    transforms: np.ndarray  # [P, 4, 4]
    ransac_fitness: np.ndarray  # [P]
    icp_rmse: np.ndarray  # [P]
    bucket_of_pair: list[int]  # bucket capacity each pair ran at
    # (-1 = restored from a checkpoint store, not dispatched this run)


def _tight(cloud: ProcessedCloud) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Valid-only (points, features, normals) of the downsampled cloud, on
    its device."""
    m = cloud.down.mask
    return cloud.down.points[m], cloud.down.features[m], cloud.down.normals[m]


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a`` cut or zero-padded to ``n`` rows."""
    pad = n - a.shape[0]
    if pad <= 0:
        return a[:n]
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def _at_cap(rows: tuple, cap: int, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """(points, features, mask, normals) on ``dev`` at capacity ``cap`` from
    a cloud's valid (points, features, normals)."""
    tp, tf, tn = (_pad_rows(x, cap).to(dev) for x in rows)
    mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
    mask[: min(int(rows[0].shape[0]), cap)] = True
    return tp, tf, mask, tn


def pair_bits_shape(
    cap: int,
    *,
    ransac_iterations: int = 4096,
    rescue_restarts: int = 0,
    sample_mode: str = "roll",
    adapt_iterations: int = 0,
) -> tuple[tuple[int, ...], tuple[int, ...] | None]:
    """One pair's (sample_bits, extra_bits) shapes at bucket capacity ``cap``:
    ``fused_register_step``'s layout for one lane at ``ransac_batch =
    min(ransac_iterations, 4096)``, with a leading restart axis when
    ``rescue_restarts`` > 0; extra_bits is None without extra chunks.  (With
    the roll sampler at bucket_multiple >= 256 the shape does not depend on
    ``cap``.)"""
    batch = min(ransac_iterations, 4096)
    chunk = chunk_bits_shape(cap, batch, sample_mode)
    lead = (rescue_restarts,) if rescue_restarts > 0 else ()
    n_extra = extra_chunk_count(ransac_iterations, adapt_iterations, batch)
    return (lead + (max(1, ransac_iterations // batch),) + chunk,
            lead + (n_extra,) + chunk if n_extra else None)


@dataclasses.dataclass(frozen=True)
class _Knobs:
    """The work knobs of one batched call, None-able ones resolved from the
    config exactly as JAX resolves them."""

    dist_thresh: float
    icp_thresh: float
    ransac_iterations: int
    icp_iterations: int
    icp_solves_per_nn: int
    approx_score: bool
    rescue_restarts: int
    score_subset: int
    rescore_top: int
    sample_mode: str
    adapt_iterations: int

    @staticmethod
    def of(config: PipelineConfig | None, *, rescue_restarts=None, score_subset=None,
           rescore_top=None, adapt_iterations=None, **kw) -> _Knobs:
        if config is None:
            config = PipelineConfig.with_voxel_size(0.3)
        r = config.ransac
        return _Knobs(
            dist_thresh=r.dist_thresh,
            icp_thresh=config.icp.dist_thresh,
            rescue_restarts=r.rescue_restarts if rescue_restarts is None else rescue_restarts,
            score_subset=r.score_subset if score_subset is None else score_subset,
            rescore_top=r.rescore_top if rescore_top is None else rescore_top,
            adapt_iterations=r.adapt_iterations if adapt_iterations is None else adapt_iterations,
            **kw,
        )

    def bits_shape(self, cap: int):
        return pair_bits_shape(cap, ransac_iterations=self.ransac_iterations,
                               rescue_restarts=self.rescue_restarts, sample_mode=self.sample_mode,
                               adapt_iterations=self.adapt_iterations)

    def step(self, src, tgt, bits, extra, dev, mesh=None):
        """One bucket: src = (points, features, mask), tgt = (points,
        features, mask, normals), each [b, cap, ...]; with a mesh, b is a
        multiple of its pair axis."""
        kw = dict(
            dist_thresh=self.dist_thresh,
            icp_thresh=self.icp_thresh,
            ransac_iterations=self.ransac_iterations,
            icp_iterations=self.icp_iterations,
            icp_solves_per_nn=self.icp_solves_per_nn,
            approx_score=self.approx_score,
            rescue_restarts=self.rescue_restarts,
            score_subset=self.score_subset,
            rescore_top=self.rescore_top,
            sample_mode=self.sample_mode,
            adapt_iterations=self.adapt_iterations,
        )
        if mesh is not None:
            return batched_register(mesh, *src, None, *tgt, bits, extra_bits=extra, **kw)
        return fused_register_step(*src, None, *tgt, bits, extra_bits=extra, device=dev,
                                   ransac_batch=min(self.ransac_iterations, 4096), **kw)


class _PairBits:
    """Each pair's (sample_bits, extra_bits): the caller's, or drawn pair
    after pair in input order."""

    def __init__(self, n: int, caps: list[int], knobs: _Knobs, pair_bits, pair_extra_bits,
                 generator):
        for name, given in (("pair_bits", pair_bits), ("pair_extra_bits", pair_extra_bits)):
            if given is not None and len(given) != n:
                raise ValueError(f"{name} has {len(given)} rows for {n} pairs")
        self.bits, self.extra = pair_bits, pair_extra_bits
        if pair_bits is not None and pair_extra_bits is None and n and \
                knobs.bits_shape(caps[0])[1] is not None:
            raise ValueError("the adaptive budget needs pair_extra_bits beside pair_bits")
        if pair_bits is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.bits, self.extra = [], []
            for cap in caps:
                shape, extra_shape = knobs.bits_shape(cap)
                self.bits.append(draw_bits(shape, generator))
                self.extra.append(None if extra_shape is None
                                  else draw_bits(extra_shape, generator))

    def of(self, idxs: list[int]) -> tuple[torch.Tensor, torch.Tensor | None]:
        bits = torch.stack([torch.as_tensor(self.bits[i]) for i in idxs])
        if self.extra is None or self.extra[idxs[0]] is None:
            return bits, None
        return bits, torch.stack([torch.as_tensor(self.extra[i]) for i in idxs])


class ResidentTarget:
    """A compacted target cloud kept on the device per capacity bucket.

    ``at_cap(cap)`` pads the valid rows to ``cap`` and uploads them once;
    later buckets at the same capacity reuse the same device tensors.  The
    host copies stay cached, so a target that sees many capacities keeps only
    the ``max_caps`` most recently used ones on the device (LRU) and
    re-uploads an evicted one from the host copy.

    ``device=None`` means CUDA, and raises when CUDA is absent.
    """

    def __init__(self, cloud: ProcessedCloud, *, max_caps: int = 8, device=None) -> None:
        self.device = resolve_device(device)
        self._host = tuple(x.cpu() for x in _tight(cloud))
        self.n_valid = int(self._host[0].shape[0])
        self.max_caps = max_caps
        self._by_cap: OrderedDict[int, tuple] = OrderedDict()

    def at_cap(self, cap: int) -> tuple[torch.Tensor, ...]:
        """(points, features, mask, normals) device tensors at capacity cap."""
        if cap not in self._by_cap:
            while len(self._by_cap) >= max(1, self.max_caps):
                self._by_cap.popitem(last=False)
            self._by_cap[cap] = _at_cap(self._host, cap, self.device)
        self._by_cap.move_to_end(cap)
        return self._by_cap[cap]


class PendingBatch:
    """Launched, not yet resolved batched registration.

    ``launch_*`` packs and dispatches every bucket and returns this; the
    bucket outputs stay device tensors until ``resolve()`` copies them to
    the host and folds them back into input order.  (The fused step syncs
    with the host inside, so a launch returns when its buckets have been
    queued to the end of their last host sync.)
    """

    def __init__(self, n: int, launched: list, done: dict, checkpoint=None, pair_names=None,
                 iterations: int = 0) -> None:
        self._n = n
        # launched: (cap, idxs, (T, fitness, rmse) device tensors) per bucket
        self._launched = launched
        self._done = done
        self._checkpoint = checkpoint
        self._pair_names = pair_names
        self._iterations = iterations

    def resolve(self) -> BatchResult:
        n = self._n
        out_T = np.zeros((n, 4, 4), np.float32)
        out_fit = np.zeros((n,), np.float32)
        out_rmse = np.zeros((n,), np.float32)
        bucket_of = [0] * n
        for cap, idxs, (T_d, fit_d, rmse_d) in self._launched:
            T, fit, rmse = (x.cpu().numpy() for x in (T_d, fit_d, rmse_d))
            for j, i in enumerate(idxs):
                out_T[i], out_fit[i], out_rmse[i] = T[j], fit[j], rmse[j]
                bucket_of[i] = cap
                if self._checkpoint is not None:
                    self._checkpoint.put_pair(
                        self._pair_names[i],
                        EdgeRecord(transformation=T[j], fitness=float(fit[j]),
                                   inlier_rmse=float(rmse[j]), iterations=self._iterations),
                    )
        for i, rec in self._done.items():
            out_T[i] = np.asarray(rec.transformation, np.float32)
            out_fit[i] = rec.fitness
            out_rmse[i] = rec.inlier_rmse
            bucket_of[i] = -1  # restored from the checkpoint store, not dispatched
        return BatchResult(out_T, out_fit, out_rmse, bucket_of)


class _Tights:
    """Each distinct cloud's valid rows once a call, and their padded copies
    on the run's device once a capacity (the pairs of a batch often share
    clouds)."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self._rows: dict[int, tuple] = {}
        self._padded: dict[tuple[int, int], tuple] = {}

    def rows(self, cloud: ProcessedCloud) -> tuple:
        key = id(cloud)
        if key not in self._rows:
            self._rows[key] = (cloud, _tight(cloud))  # the cloud keeps its id alive
        return self._rows[key][1]

    def n_valid(self, cloud: ProcessedCloud) -> int:
        return int(self.rows(cloud)[0].shape[0])

    def padded(self, cloud: ProcessedCloud, cap: int) -> tuple:
        """(points, features, mask, normals) at capacity ``cap`` on the device."""
        key = (id(cloud), cap)
        if key not in self._padded:
            self._padded[key] = _at_cap(self.rows(cloud), cap, self.dev)
        return self._padded[key]


def _stacked(parts: list[tuple], which: tuple[int, ...]) -> list[torch.Tensor]:
    return [torch.stack([p[w] for p in parts]) for w in which]


def launch_pairs_batched(
    pairs: list[tuple[ProcessedCloud, ProcessedCloud]],
    config: PipelineConfig | None = None,
    *,
    generator: torch.Generator | None = None,
    mesh=None,
    bucket_multiple: int = 256,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 2,
    approx_score: bool = True,
    rescue_restarts: int | None = None,
    score_subset: int | None = None,
    rescore_top: int | None = None,
    sample_mode: str = "roll",
    adapt_iterations: int | None = None,
    checkpoint=None,
    pair_names: list[str] | None = None,
    pair_bits=None,
    pair_extra_bits=None,
    device=None,
) -> PendingBatch:
    """Pack and dispatch the buckets of ``register_pairs_batched`` and return
    a ``PendingBatch``; see ``register_pairs_batched`` for the arguments."""
    if mesh is not None:
        check_mesh("launch_pairs_batched", mesh)
    if checkpoint is not None and pair_names is None:
        raise ValueError("checkpoint requires pair_names")
    knobs = _Knobs.of(config, rescue_restarts=rescue_restarts, score_subset=score_subset,
                      rescore_top=rescore_top, adapt_iterations=adapt_iterations,
                      ransac_iterations=ransac_iterations, icp_iterations=icp_iterations,
                      icp_solves_per_nn=icp_solves_per_nn, approx_score=approx_score,
                      sample_mode=sample_mode)
    dev = resolve_device(device)
    n_pairs = len(pairs)
    if n_pairs == 0:
        return PendingBatch(0, [], {})

    # --- resume: the pairs the checkpoint store already holds ---------------
    done: dict[int, EdgeRecord] = {}
    if checkpoint is not None:
        for i, name in enumerate(pair_names):
            rec = checkpoint.get_pair(name)
            if rec is not None:
                done[i] = rec

    # --- valid rows, capacities, buckets, bits --------------------------------
    tights = _Tights(dev)
    caps = [round_up(max(tights.n_valid(s), tights.n_valid(t), 1), bucket_multiple)
            for s, t in pairs]
    bits = _PairBits(n_pairs, caps, knobs, pair_bits, pair_extra_bits, generator)
    buckets: dict[int, list[int]] = {}
    for i, cap in enumerate(caps):
        if i not in done:
            buckets.setdefault(cap, []).append(i)

    quantum = mesh.shape[PAIR_AXIS] if mesh is not None else 1
    launched = []
    for cap, idxs in sorted(buckets.items()):
        # The mesh's quantum: repeats of the bucket's first pair (and its
        # bits), dropped after the step.
        lanes = idxs + [idxs[0]] * (round_up(len(idxs), quantum) - len(idxs))
        src = [tights.padded(pairs[i][0], cap) for i in lanes]
        tgt = [tights.padded(pairs[i][1], cap) for i in lanes]
        b, extra = bits.of(lanes)
        out = knobs.step(_stacked(src, (0, 1, 2)), _stacked(tgt, (0, 1, 2, 3)), b, extra, dev,
                         mesh)
        launched.append((cap, idxs, tuple(x[:len(idxs)] for x in out)))
    return PendingBatch(n_pairs, launched, done, checkpoint=checkpoint, pair_names=pair_names,
                        iterations=ransac_iterations)


def register_pairs_batched(
    pairs: list[tuple[ProcessedCloud, ProcessedCloud]],
    config: PipelineConfig | None = None,
    **kwargs,
) -> BatchResult:
    """Register many preprocessed pairs, one ``fused_register_step`` call a
    capacity bucket.

    Args:
      pairs: (source, target) ``ProcessedCloud`` tuples.
      config: pipeline config (thresholds); defaults to voxel 0.3 constants.
      generator / pair_bits / pair_extra_bits: each pair's RANSAC bits (see
        the module docstring and ``pair_bits_shape``); a wrong shape raises.
      mesh: optional ``parallel.mesh.Mesh``: each bucket is padded to a
        multiple of its pair axis and split over it (``batched_register``);
        results equal the call without a mesh, bit for bit.
      bucket_multiple: capacity quantum for grouping.
      ransac_iterations / icp_iterations / icp_solves_per_nn / approx_score /
        sample_mode: per-pair work knobs.
      rescue_restarts: > 0 runs the batched alias rescue inside the fused
        step; None takes config.ransac.rescue_restarts.
      score_subset / rescore_top / adapt_iterations: two-stage scoring and
        the adaptive budget; None takes the config values.
      checkpoint: optional ``multiway.checkpoint.CheckpointStore``: each
        pair's result is persisted (atomic npz) at ``resolve()``, and pairs
        already stored are restored, not dispatched.  Requires
        ``pair_names``, a stable identity string per pair.
      device: None means CUDA and raises without it; "cpu" runs the plain
        PyTorch versions.

    Returns:
      BatchResult with arrays indexed like ``pairs``.
    """
    return launch_pairs_batched(pairs, config, **kwargs).resolve()


def launch_sources_to_target(
    sources: list[ProcessedCloud],
    target: ResidentTarget,
    config: PipelineConfig | None = None,
    *,
    generator: torch.Generator | None = None,
    pair_bits=None,
    pair_extra_bits=None,
    bucket_multiple: int = 256,
    ransac_iterations: int = 4096,
    icp_iterations: int = 8,
    icp_solves_per_nn: int = 2,
    approx_score: bool = True,
    rescue_restarts: int | None = None,
    score_subset: int | None = None,
    rescore_top: int | None = None,
    sample_mode: str = "roll",
    adapt_iterations: int | None = None,
) -> PendingBatch:
    """Pack and dispatch the buckets of ``register_sources_to_target``."""
    knobs = _Knobs.of(config, rescue_restarts=rescue_restarts, score_subset=score_subset,
                      rescore_top=rescore_top, adapt_iterations=adapt_iterations,
                      ransac_iterations=ransac_iterations, icp_iterations=icp_iterations,
                      icp_solves_per_nn=icp_solves_per_nn, approx_score=approx_score,
                      sample_mode=sample_mode)
    dev = target.device
    n = len(sources)
    tights = _Tights(dev)
    caps = [round_up(max(tights.n_valid(s), target.n_valid, 1), bucket_multiple)
            for s in sources]
    bits = _PairBits(n, caps, knobs, pair_bits, pair_extra_bits, generator)
    buckets: dict[int, list[int]] = {}
    for i, cap in enumerate(caps):
        buckets.setdefault(cap, []).append(i)

    launched = []
    for cap, idxs in sorted(buckets.items()):
        src = _stacked([tights.padded(sources[i], cap) for i in idxs], (0, 1, 2))
        tgt = [x.expand((len(idxs),) + tuple(x.shape)).contiguous() for x in target.at_cap(cap)]
        b, extra = bits.of(idxs)
        launched.append((cap, idxs, knobs.step(src, tgt, b, extra, dev)))
    return PendingBatch(n, launched, {})


def register_sources_to_target(
    sources: list[ProcessedCloud],
    target: ResidentTarget,
    config: PipelineConfig | None = None,
    **kwargs,
) -> BatchResult:
    """Register many source clouds against ONE device-resident target.

    Same per-pair semantics as ``register_pairs_batched`` (padding is
    masked, so the results equal the pair-batched call's for the same bits,
    and the None-able knobs resolve from ``config`` the same way); only the
    sources are packed per call.  Runs on ``target.device``.
    """
    return launch_sources_to_target(sources, target, config, **kwargs).resolve()
