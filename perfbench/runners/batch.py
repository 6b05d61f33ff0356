"""Closed-loop batch registration through ``register_pairs_batched``.

Set-up makes a pool of ``pool_pairs`` pairs on the device (``make_pool``:
all but ``seed_pairs`` of them the same for every seed, from the traffic's
``pool_seed``, and ``seed_pairs`` drawn from the seed), preprocesses every
cloud once (``preprocess_points_batch``, down clouds only), and warms up
with ``warm_calls`` untimed calls.  The window then makes call after call,
each over ``call_pairs`` pairs: a permutation of the pool drawn from the
seed, with its own RANSAC bits (a generator seeded from the seed and the
call's number), until ``--seconds`` have passed; every call's results
reach the host before the next starts.

End-to-end: ``pairs_per_s``, the pairs whose results reached the host over
the window's seconds.  Failed: the pairs that came back with no answer (a
pose or an RMSE that is not finite).  Correct: the share of answers
outside the configuration's gate of their true poses within the share it
allows, and a sample of ``check_pairs`` answers, drawn from the seed,
against the plain reference's answer for the same raw clouds
(``reference.registration.downsampled_answer``).  An answer outside the
gate says the wrong thing, so it is for ``correct``, not ``failed``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import check, costs, gate, program, synthetic
from perfbench.reference import registration as reference


class Runner:
    def __init__(self, run) -> None:
        self.run = run
        self.cfg = run.config
        self.tr = run.traffic
        self.calls: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []  # perm, T, rmse
        self.call_s: list[float] = []
        self.traced_calls: list[int] = []
        self.elapsed = 0.0

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch
        from tpu3dm_torch.registration import batch

        run, cfg, tr = self.run, self.cfg, self.tr
        self.batch = batch
        self.pipeline = program.pipeline_config(cfg)
        self.src, self.tgt, self.T_true = make_pool(run)
        self.mu, self.M2 = gate.moments(self.src)
        with run.tracer.span("preprocess"):
            procs = preprocess_points_batch(list(self.src) + list(self.tgt),
                                            self.pipeline.preprocess, full_normals=False,
                                            device=run.device)
        n = tr["pool_pairs"]
        self.pairs = [(procs[i], procs[n + i]) for i in range(n)]
        for c in range(tr["warm_calls"]):
            self._call(-1 - c)
        self._sync()

    def _sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _call(self, c: int):
        cfg, tr = self.cfg, self.tr
        rng = np.random.default_rng(synthetic.call_seed(self.run.seed, c))
        perm = rng.permutation(tr["pool_pairs"])[: tr["call_pairs"]]
        bits = torch.Generator().manual_seed(synthetic.call_seed(self.run.seed, c) ^ 0x5EED)
        with self.run.tracer.span("register_pairs_batched"):
            res = self.batch.register_pairs_batched(
                [self.pairs[i] for i in perm], self.pipeline, generator=bits,
                bucket_multiple=cfg["bucket_multiple"],
                ransac_iterations=cfg["ransac_iterations"], icp_iterations=cfg["icp_iterations"],
                icp_solves_per_nn=cfg["icp_solves_per_nn"], approx_score=cfg["approx_score"],
                rescue_restarts=cfg["rescue_restarts"], device=self.run.device)
        return perm, res

    # -- the window --------------------------------------------------------------

    def window(self) -> dict:
        tracer = self.run.tracer
        t0 = time.perf_counter()
        tracer.start()
        c = 0
        while True:
            traced = tracer.active
            t1 = time.perf_counter()
            perm, res = self._call(c)
            self.call_s.append(time.perf_counter() - t1)
            self.calls.append((perm, res.transforms, res.icp_rmse))
            if traced:
                self.traced_calls.append(c)
            c += 1
            self.elapsed = time.perf_counter() - t0
            tracer.maybe_stop()
            if self.elapsed >= self.run.seconds:
                break
        tracer.stop()
        pairs = sum(len(p) for p, _, _ in self.calls)
        return {"pairs_per_s": pairs / self.elapsed}

    def release(self) -> None:
        del self.pairs
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------------

    def check(self) -> check.Verdict:
        cfg = self.cfg
        perm = np.concatenate([p for p, _, _ in self.calls])
        T = np.concatenate([t for _, t, _ in self.calls]).astype(np.float64)
        rmse = np.concatenate([r for _, _, r in self.calls]).astype(np.float64)
        _, _, missed = gate.gate_misses(T, self.T_true[perm], self.mu[perm], self.M2[perm],
                                        cfg["gate"]["rotation_deg"], cfg["gate"]["alignment_rmse"])
        self.n_missed = int(missed.sum())
        answered = np.isfinite(T).all(axis=(-2, -1)) & np.isfinite(rmse)
        picks = check.sample(len(perm), cfg["check_pairs"], self.run.seed, among=~missed)
        refs = reference_answers(cfg, self.src, self.tgt, self.T_true, perm[picks],
                                 self.run.device)
        numbers = check.gap_numbers(T[picks], rmse[picks], refs, self.mu[perm[picks]],
                                    self.M2[perm[picks]])
        self.rmse_gaps = {k: v for k, v in numbers.items() if k.startswith("rmse_gap_rel")}
        checks = [check.gate_check(missed, cfg["gate"])]
        checks += check.limited(numbers, cfg["limits"])
        return check.Verdict(attempted=len(perm), failed=int((~answered).sum()),
                             checks=checks)

    # -- what the per-layer metrics read ------------------------------------------

    def counters(self) -> dict:
        return {}

    def work(self) -> dict:
        """The traced calls' pairs and the least time of their mutual FPFH
        searches, from the reference's own voxel counts."""
        voxel, dev = self.cfg["voxel_size"], self.run.device
        rows = {}
        pairs, bound = 0, 0.0
        for c in self.traced_calls:
            perm = self.calls[c][0]
            for i in perm:
                if i not in rows:
                    rows[i] = (reference.voxel_count(torch.from_numpy(self.src[i]).to(dev), voxel),
                               reference.voxel_count(torch.from_numpy(self.tgt[i]).to(dev), voxel))
            bound += costs.lane_mutual_seconds([rows[i][0] for i in perm],
                                               [rows[i][1] for i in perm])
            pairs += len(perm)
        return {"pairs_traced": pairs, "lane_mutual_bound_s": bound}

    def notes(self) -> list[str]:
        pairs = sum(len(p) for p, _, _ in self.calls)
        q = np.percentile(self.call_s, [0, 50, 100]) if self.call_s else [0, 0, 0]
        gaps = ", ".join(f"{k} {v!r}" for k, v in getattr(self, "rmse_gaps", {}).items())
        return [f"batch: {len(self.calls)} calls, {pairs} pairs in {self.elapsed:.3f} s, "
                f"{self.n_missed} outside the gate; traced calls {len(self.traced_calls)}; "
                f"s a call min {q[0]:.4f} median {q[1]:.4f} max {q[2]:.4f}",
                f"batch: the sample's RMSE gaps: {gaps}"]


def make_pool(run) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, tgt, T_true) host arrays of the cell's pool, made on the device:
    ``pool_pairs - seed_pairs`` pairs from the traffic's fixed ``pool_seed``,
    the same for every seed, and ``seed_pairs`` from the run's seed.  Most
    of the work is the same from seed to seed; every seed brings pairs of
    its own, in its own order and with its own RANSAC bits."""
    cfg, tr = run.config, run.traffic
    parts = []
    for seed, b in ((tr["pool_seed"], tr["pool_pairs"] - tr["seed_pairs"]),
                    (run.seed, tr["seed_pairs"])):
        if b > 0:
            gen = synthetic.generator(seed, 0, run.device)
            parts.append(synthetic.make_pairs(cfg["family"], b, cfg["points"], gen,
                                              sigma=cfg["sigma"]))
    return tuple(torch.cat(x).cpu().numpy() for x in zip(*parts))


def reference_answers(cfg: dict, src, tgt, T_true, pool_idx, device, *,
                      tf32: bool = False) -> list:
    """(T [4, 4], inlier RMSE) of the plain reference for each pool pair in
    ``pool_idx`` (repeats computed once): TF32 off, the configuration's
    float32; ``tf32`` runs the control one precision below."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        done = {}
        for i in pool_idx:
            i = int(i)
            if i not in done:
                T, r = reference.downsampled_answer(
                    torch.from_numpy(src[i]).to(device), torch.from_numpy(tgt[i]).to(device),
                    torch.from_numpy(T_true[i]).to(device), voxel=cfg["voxel_size"],
                    normal_radius=program.normal_radius(cfg), normal_max_nn=cfg["normal_max_nn"],
                    thresh=program.icp_thresh(cfg))
                done[i] = (T.cpu().numpy(), r)
        return [done[int(i)] for i in pool_idx]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
