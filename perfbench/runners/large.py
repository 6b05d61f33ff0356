"""Closed-loop registration of full-resolution pairs through
``register_arrays_large``, one pair a call, clouds already on the device.

Set-up makes a pool of ``base_pairs`` x ``motions`` pairs on the device
(``make_pool``): ``base_pairs`` arch pairs of ``points`` points (the target
the source's points under a rigid motion, each cloud with its own noise of
``sigma``), all but ``seed_base_pairs`` of them from the traffic's fixed
``pool_seed`` and those from the run's seed; each base pair's target under
``motions`` rigid motions, all from ``pool_seed``.  The pool stays on the
device as float32 tensors, as a caller holds scans there.  It warms up
with ``warm_calls`` untimed calls.  The window then registers pair after
pair, in an order of the pool drawn from the seed and repeated, each call
with fresh RANSAC bits (a generator on the device, seeded from the seed and
the call's number, so the bits are drawn there), until ``--seconds`` have
passed; each call's pose, fitness and RMSE reach the host before the next
starts.

End-to-end: ``pairs_per_s``, the pairs registered over the window's
seconds.  Failed: the calls that came back with no answer (a pose or an
RMSE that is not finite).  Correct: the share of answers outside the
configuration's gate of their true poses within the share it allows, and a
sample of ``check_pairs`` answers, drawn from the seed, against the plain
reference's answer for the same pair (``reference.large.icp``: exact
point-to-plane ICP at full resolution from the true pose to its optimum):
the rotation between the poses, the relative gap of the inlier RMSEs and
the gap of the fitnesses, each the worst over the sample.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import check, costs_large, gate, program, synthetic
from perfbench.reference import large as reference


class Runner:
    def __init__(self, run) -> None:
        self.run = run
        self.cfg = run.config
        self.tr = run.traffic
        self.answers: list[tuple[int, np.ndarray]] = []  # pool index, [18] T, fitness, RMSE
        self.call_s: list[float] = []
        self.traced_calls = 0
        self.elapsed = 0.0

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from tpu3dm_torch.registration.large import register_arrays_large

        run, tr = self.run, self.tr
        self.register = register_arrays_large
        self.pipeline = program.pipeline_config(self.cfg)
        self.src, self.tgt, self.T_true = make_pool(run)
        self.mu, self.M2 = moments(self.src)
        self.motions = tr["motions"]
        n = self.tgt.shape[0]
        self.order = np.random.default_rng(synthetic.mix(run.seed, 2)).permutation(n)
        for c in range(tr["warm_calls"]):
            self._call(-1 - c, int(self.order[c % n]))

    def _call(self, c: int, i: int) -> np.ndarray:
        cfg = self.cfg
        bits = torch.Generator(device=self.run.device).manual_seed(
            synthetic.call_seed(self.run.seed, c) ^ 0x5EED)
        with self.run.tracer.span("register_arrays_large"):
            fine, _ = self.register(
                self.src[i // self.motions], self.tgt[i], self.pipeline, generator=bits,
                block=cfg["block"], w=cfg["w"], restarts=cfg["restarts"],
                device=self.run.device)
            return torch.cat([fine.transformation.reshape(16).to(torch.float64),
                              fine.fitness.reshape(1).to(torch.float64),
                              fine.inlier_rmse.reshape(1).to(torch.float64)]).cpu().numpy()

    # -- the window --------------------------------------------------------------

    def window(self) -> dict:
        tracer = self.run.tracer
        t0 = time.perf_counter()
        tracer.start()
        c = 0
        while True:
            traced = tracer.active
            i = int(self.order[c % len(self.order)])
            t1 = time.perf_counter()
            out = self._call(c, i)
            self.call_s.append(time.perf_counter() - t1)
            self.answers.append((i, out))
            self.traced_calls += traced
            c += 1
            self.elapsed = time.perf_counter() - t0
            tracer.maybe_stop()
            if self.elapsed >= self.run.seconds:
                break
        tracer.stop()
        return {"pairs_per_s": len(self.answers) / self.elapsed}

    def release(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------------

    def check(self) -> check.Verdict:
        cfg = self.cfg
        t0 = time.perf_counter()
        idx = np.asarray([i for i, _ in self.answers], np.int64)
        out = np.stack([a for _, a in self.answers])
        T, fit, rmse = out[:, :16].reshape(-1, 4, 4), out[:, 16], out[:, 17]
        base = idx // self.motions
        rot, rms, missed = gate.gate_misses(T, self.T_true[idx], self.mu[base], self.M2[base],
                                            cfg["gate"]["rotation_deg"],
                                            cfg["gate"]["alignment_rmse"])
        self.misses = [(int(k), int(idx[k]), float(rot[k]), float(rms[k]))
                       for k in np.flatnonzero(missed)]
        answered = np.isfinite(T).all(axis=(-2, -1)) & np.isfinite(rmse)
        picks = check.sample(len(idx), cfg["check_pairs"], self.run.seed)
        refs = reference_answers(cfg, self.src, self.tgt, self.T_true, self.motions, idx[picks])
        self.numbers = answer_numbers(T[picks], fit[picks], rmse[picks], refs,
                                      self.mu[base[picks]], self.M2[base[picks]])
        self.check_s = time.perf_counter() - t0
        checks = [check.gate_check(missed, cfg["gate"])]
        checks += check.limited(self.numbers, cfg["limits"])
        return check.Verdict(attempted=len(idx), failed=int((~answered).sum()), checks=checks)

    # -- what the per-layer metrics read ------------------------------------------

    def counters(self) -> dict:
        return {}

    def work(self) -> dict:
        """The traced calls, and the least time of one launch of the
        block-sparse search over a pool cloud (``lib/costs_large.py``, from
        the pool's own point count and the configuration's block and w)."""
        n, block, w = self.cfg["points"], self.cfg["block"], self.cfg["w"]
        return {"pairs_traced": self.traced_calls,
                "nn_blocksparse_launch_s": costs_large.nn_blocksparse_seconds(
                    -(-n // block), w, block, n)}

    def notes(self) -> list[str]:
        q = np.percentile(self.call_s, [0, 50, 100]) if self.call_s else [0, 0, 0]
        nums = ", ".join(f"{k} {v!r}" for k, v in getattr(self, "numbers", {}).items())
        return [f"large: {len(self.answers)} calls in {self.elapsed:.3f} s; traced calls "
                f"{self.traced_calls}; s a call min {q[0]:.4f} median {q[1]:.4f} max {q[2]:.4f}",
                f"large: the check took {getattr(self, 'check_s', 0.0):.1f} s; {nums}",
                "large: outside the gate (call, pair, deg, alignment RMSE): "
                f"{getattr(self, 'misses', [])}"]


def make_pool(run) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """(src [b, n, 3], tgt [b * m, n, 3]) float32 tensors on the device and
    T_true [b * m, 4, 4] float64 host poses, b = ``base_pairs`` and m =
    ``motions``: pair i is source i // m and target i, with tgt ~ T_true src.
    ``base_pairs - seed_base_pairs`` base pairs from the traffic's
    ``pool_seed``, the rest from the run's seed; every motion from
    ``pool_seed``."""
    cfg, tr, dev = run.config, run.traffic, run.device
    parts = []
    for seed, b in ((tr["pool_seed"], tr["base_pairs"] - tr["seed_base_pairs"]),
                    (run.seed, tr["seed_base_pairs"])):
        if b > 0:
            gen = synthetic.generator(seed, 0, dev)
            parts.append(synthetic.arch_pairs(b, cfg["points"], gen, sigma=cfg["sigma"]))
    src, tgt, T = (torch.cat(x) for x in zip(*parts))
    m = tr["motions"]
    gen = synthetic.generator(tr["pool_seed"], 1, dev)
    moved, T_true = [], []
    for b in range(src.shape[0]):
        M = synthetic.rigid_motions(m, tgt[b].to(torch.float64).mean(dim=0).expand(m, 3), gen)
        moved.append(synthetic.apply(M, tgt[b].to(torch.float64).expand(m, -1, 3)).float())
        T_true.append(M @ T[b])
    return src, torch.cat(moved), torch.cat(T_true).cpu().numpy()


def moments(src: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(mu [b, 3], M2 [b, 3, 3]) float64 host moments of [b, n, 3] clouds
    (``gate.moments``, taken on the clouds' device)."""
    p = src.to(torch.float64)
    return (p.mean(dim=1).cpu().numpy(),
            (p.transpose(1, 2) @ p / p.shape[1]).cpu().numpy())


def reference_answers(cfg: dict, src, tgt, T_true, motions: int, pool_idx, *,
                      tf32: bool = False) -> list:
    """(T [4, 4], fitness, inlier RMSE) of the plain reference for each pool
    pair in ``pool_idx`` (repeats computed once): TF32 off, the
    configuration's float32; ``tf32`` runs the control one precision below."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        done = {}
        for i in (int(i) for i in pool_idx):
            if i not in done:
                T, fit, rmse, _ = reference.icp(
                    src[i // motions], tgt[i], torch.from_numpy(T_true[i]).to(tgt.device),
                    voxel=cfg["voxel_size"], normal_radius=program.normal_radius(cfg),
                    normal_max_nn=cfg["normal_max_nn"], thresh=program.icp_thresh(cfg))
                done[i] = (T.cpu().numpy(), fit, rmse)
        return [done[int(i)] for i in pool_idx]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def answer_numbers(T, fit, rmse, refs, mus, M2s) -> dict:
    """The gaps of answers (T [S, 4, 4], fitness [S], RMSE [S]) to the
    reference's ``refs``: ``lib.check.gap_numbers`` (the poses' rotation
    and RMS gaps, the RMSEs' relative gaps) and ``fitness_gap``, the worst
    absolute gap of the fitnesses.  Empty for no answers."""
    if len(refs) == 0:
        return {}
    numbers = check.gap_numbers(T, rmse, [(t, r) for t, _, r in refs], mus, M2s)
    gaps = np.abs(np.asarray(fit, np.float64) - np.asarray([f for _, f, _ in refs]))
    numbers["fitness_gap"] = check.worst(np.where(np.isfinite(gaps), gaps, np.inf))
    return numbers


def control_numbers(run) -> tuple[dict, list]:
    """The cell's numbers for the control, the plain reference one precision
    below (TF32 on) put in the program's place on ``check_pairs`` pool pairs
    drawn from the seed, and the checks of those the configuration limits
    (with the gate's miss share)."""
    cfg, tr = run.config, run.traffic
    src, tgt, T_true = make_pool(run)
    mu, M2 = moments(src)
    picks = check.sample(tgt.shape[0], cfg["check_pairs"], run.seed)
    refs = reference_answers(cfg, src, tgt, T_true, tr["motions"], picks)
    ctl = reference_answers(cfg, src, tgt, T_true, tr["motions"], picks, tf32=True)
    T_c = np.stack([t for t, _, _ in ctl])
    base = picks // tr["motions"]
    _, _, missed = gate.gate_misses(T_c, T_true[picks], mu[base], M2[base],
                                    cfg["gate"]["rotation_deg"], cfg["gate"]["alignment_rmse"])
    numbers = answer_numbers(T_c, [f for _, f, _ in ctl], [r for _, _, r in ctl], refs,
                             mu[base], M2[base])
    gate_c = check.gate_check(missed, cfg["gate"])
    numbers[gate_c.name] = gate_c.value
    return numbers, [gate_c] + check.limited(numbers, cfg["limits"])
