"""Kernel microbenchmarks with roofline (speed-of-light) analysis (port of
tpu3dm/apps/kernelbench.py).

Times the port's NN-search and RANSAC-scoring kernels at the JAX module's
shapes and reports each against an explicit hardware model: the bound of a
case is the larger of the bytes its function must move (each input read
once, each output written once) over the memory rate, and its operations
over the peak rate of their kind.  ``sol_bound`` names the binding
resource: ``hbm``, ``fp32`` (fp32 instructions outside the tensor cores: an
FMA, an add, a multiply, a subtraction or a compare each count one) or
``tensor`` (bf16 tensor-core flops).

Cases (JAX's, ``tpu3dm/apps/kernelbench.py:203-246``):
  - kernel 4 (``ops/nn.py:nn_search_tiled`` at d = 3): 16384^2, 65536^2 and
    1048576 x 16384 (the large-cloud donor-normal shape);
  - kernel 5 (d = 33): 16384^2, 65536^2;
  - the dense search (``nn_search_dense``) at 2048^2, d = 33;
  - the RANSAC score: the dense route at 4096^2 (K N <= 2^24), then kernel
    3's fp32 route (``score_features`` on one lane) at 16384 x 65536 and
    65536^2.

Timing: one warm-up call, then the median of ``reps`` calls, each between two
CUDA events (``time.perf_counter`` on the CPU).  The dispatch floor is one
trivial launch timed the same way; ``pct_of_sol_net`` takes it off.  On the
CPU the wrappers run their plain versions, the peaks are placeholders and
cases above 2^28 entries are skipped.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from tpu3dm_torch import resolve_device
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)

# Hardware peaks.  "cuda": one H100 SXM at 700 W, NVIDIA's published dense
# figures: HBM3 bandwidth; fp32 outside the tensor cores, 67 TFLOP/s counting
# an FMA as two flops, so fp32 instructions issue at half that rate; bf16
# tensor cores with fp32 accumulation.  chip_smoke.py bounds its kernel rows
# with these same numbers.  "cpu": placeholders so the harness runs anywhere;
# its percentages mean nothing.
PEAKS = {
    "cuda": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops": 67e12,
        "fp32_ops_per_s": 33.5e12,
        "bf16_tensor_flops": 989e12,
        "name": "NVIDIA H100 SXM (published dense peaks)",
    },
    "cpu": {
        "hbm_bytes_per_s": 5e10,
        "fp32_flops": 4e11,
        "fp32_ops_per_s": 2e11,
        "bf16_tensor_flops": 4e11,
        "name": "host CPU (placeholder model)",
    },
}

# Case shapes: (nq, nt, d) searches and (k, n) scores; QUICK runs the first
# of each list only.
NN_SHAPES_QUICK = [(16384, 16384, 3), (16384, 16384, 33)]
NN_SHAPES_FULL = [(65536, 65536, 3), (1048576, 16384, 3), (65536, 65536, 33)]
DENSE_SHAPE = (2048, 2048, 33)
SCORE_SHAPES_QUICK = [(4096, 4096)]
SCORE_SHAPES_FULL = [(16384, 65536), (65536, 65536)]
SCORE_THRESH_SQ = 0.01
CPU_MAX_ENTRIES = 1 << 28
DEFAULT_OUT = "torch_runs/kernel_roofline.json"


def sol_time(peaks: dict, hbm_bytes: float, *, fp32: float = 0.0,
             tensor: float = 0.0) -> tuple[float, str]:
    """(seconds, bound): the larger of bytes over the memory rate, fp32
    instructions over their rate and tensor-core flops over theirs, and the
    name of the one that binds ("hbm", "fp32" or "tensor")."""
    times = {
        "hbm": hbm_bytes / peaks["hbm_bytes_per_s"],
        "fp32": fp32 / peaks["fp32_ops_per_s"],
        "tensor": tensor / peaks["bf16_tensor_flops"],
    }
    bound = max(times, key=times.get)
    return times[bound], bound


@dataclasses.dataclass
class KernelCase:
    """One measured kernel configuration with its cost model."""

    name: str
    entries: int  # A*B interaction-matrix entries
    hbm_bytes: float  # each input read once, each output written once
    fp32_ops: float  # fp32 instructions the function needs
    tensor_flops: float = 0.0  # tensor-core flops the function needs
    time_s: float = 0.0

    def roofline(self, peaks: dict) -> dict:
        sol, bound = sol_time(peaks, self.hbm_bytes, fp32=self.fp32_ops,
                              tensor=self.tensor_flops)
        t = self.time_s
        return {
            "name": self.name,
            "entries": self.entries,
            "time_ms": round(t * 1e3, 4),
            "entries_per_sec": round(self.entries / t) if t else None,
            "achieved_gops": round((self.fp32_ops + self.tensor_flops) / t / 1e9, 1) if t else None,
            "achieved_gbytes_per_sec": round(self.hbm_bytes / t / 1e9, 1) if t else None,
            "sol_time_ms": round(sol * 1e3, 4),
            "sol_bound": bound,
            "pct_of_sol": round(100.0 * sol / t, 1) if t else None,
        }


def _time_fn(fn, dev: torch.device, reps: int = 5) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after one warm-up call."""
    fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


# --------------------------------------------------------------------------
# Cost models: the function's work, whatever the tiling
# --------------------------------------------------------------------------


def _nn_case(nq: int, nt: int, d: int, *, dense: bool) -> KernelCase:
    """Top-1 NN of nq queries over nt targets in d dimensions.  fp32
    instructions an entry: below d = 8 the direct form (d subtractions, d
    squares, d adds); above, d FMAs of the cross term and one FMA of the -2
    scale with |t|^2.  Bytes: both point sets, d2 and idx of every query."""
    entries = nq * nt
    ops = (3.0 * d if d < 8 else d + 1.0) * entries
    hbm = 4.0 * d * (nq + nt) + 8.0 * nq
    kind = "dense" if dense else "tiled"
    return KernelCase(f"nn_{kind}_{nq}x{nt}_d{d}", entries, hbm, ops)


def _score_case(k: int, n: int, *, dense: bool) -> KernelCase:
    """Inlier counts of k hypotheses over n correspondences: 16 FMAs of the
    rank-15 form, the adds of c and e and the compare (19 fp32 instructions
    an entry).  Bytes: H (64 B), e and the count of each hypothesis; F (64
    B), c and the mask byte of each correspondence."""
    entries = k * n
    hbm = k * (64.0 + 4.0 + 4.0) + n * (64.0 + 4.0 + 1.0)
    kind = "dense" if dense else "lane"
    return KernelCase(f"score_{kind}_{k}x{n}", entries, hbm, 19.0 * entries)


def nn_inputs(nq: int, nt: int, d: int, rng: np.random.Generator, dev: torch.device):
    """The search cases' inputs: standard normal queries and targets."""
    q = torch.as_tensor(rng.standard_normal((nq, d)), dtype=torch.float32, device=dev)
    t = torch.as_tensor(rng.standard_normal((nt, d)), dtype=torch.float32, device=dev)
    return q, t


def score_inputs(k: int, n: int, rng: np.random.Generator, dev: torch.device):
    """The score cases' inputs (JAX's): identity rotations, translations of
    scale 0.1, points of scale 1 and their copies moved by noise of 0.05;
    every correspondence valid."""
    R = torch.eye(3, dtype=torch.float32, device=dev).repeat(k, 1, 1)
    t = torch.as_tensor(rng.standard_normal((k, 3)) * 0.1, dtype=torch.float32, device=dev)
    p_np = rng.standard_normal((n, 3))
    p = torch.as_tensor(p_np, dtype=torch.float32, device=dev)
    q = p + torch.as_tensor(rng.standard_normal((n, 3)) * 0.05, dtype=torch.float32, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    return R, t, p, q, mask


def score_lane_operands(R, t, p, q, mask):
    """One lane of ``score_features``' operands (H, e, F, c, mask)."""
    from tpu3dm_torch.ops.ransac_score import corres_features, hypothesis_features

    F, c = corres_features(p, q)
    H, e = hypothesis_features(R, t)
    return tuple(x[None].contiguous() for x in (H, e, F, c, mask))


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------


def run_kernel_benchmark(*, quick: bool = False, out_path: str | None = DEFAULT_OUT,
                         device=None, reps: int = 5) -> dict:
    """Measure the NN and scorer kernels and report roofline percentages."""
    from tpu3dm_torch.ops.nn import nn_search_dense, nn_search_tiled
    from tpu3dm_torch.ops.ransac_score import score_features, score_hypotheses_dense

    dev = resolve_device(device)
    peaks = PEAKS["cuda" if dev.type == "cuda" else "cpu"]
    logger.info("kernel bench on %s, model %s", dev, peaks["name"])

    # Dispatch floor: one trivial launch.
    tiny = torch.zeros((8,), dtype=torch.float32, device=dev)
    floor_s = _time_fn(lambda: tiny + 1.0, dev, reps)
    logger.info("dispatch floor: %.4f ms", floor_s * 1e3)

    rng = np.random.default_rng(0)
    cases: list[KernelCase] = []

    # --- kernels 4 and 5 ----------------------------------------------------
    nn_shapes = list(NN_SHAPES_QUICK) + ([] if quick else list(NN_SHAPES_FULL))
    for nq, nt, d in nn_shapes:
        if dev.type == "cpu" and nq * nt > CPU_MAX_ENTRIES:
            continue
        q, t = nn_inputs(nq, nt, d, rng, dev)
        case = _nn_case(nq, nt, d, dense=False)
        case.time_s = _time_fn(lambda q=q, t=t: nn_search_tiled(q, t), dev, reps)
        cases.append(case)
        del q, t

    # --- the dense comparison point at a registration-scale shape ---------
    nq, nt, d = DENSE_SHAPE
    q, t = nn_inputs(nq, nt, d, rng, dev)
    case = _nn_case(nq, nt, d, dense=True)
    case.time_s = _time_fn(lambda: nn_search_dense(q, t), dev, reps)
    cases.append(case)

    # --- the RANSAC score ----------------------------------------------------
    score_shapes = list(SCORE_SHAPES_QUICK) + ([] if quick else list(SCORE_SHAPES_FULL))
    for k, n in score_shapes:
        if dev.type == "cpu" and k * n > CPU_MAX_ENTRIES:
            continue
        R, tt, p, qq, mask = score_inputs(k, n, rng, dev)
        dense = k * n <= (1 << 24)
        case = _score_case(k, n, dense=dense)
        if dense:
            case.time_s = _time_fn(
                lambda: score_hypotheses_dense(R, tt, p, qq, mask, SCORE_THRESH_SQ), dev, reps)
        else:
            ops = score_lane_operands(R, tt, p, qq, mask)
            case.time_s = _time_fn(lambda ops=ops: score_features(*ops, SCORE_THRESH_SQ),
                                   dev, reps)
            del ops
        cases.append(case)

    rows = [c.roofline(peaks) for c in cases]
    for c, r in zip(cases, rows):
        net = c.time_s - floor_s
        # Cases at or under the dispatch floor measure the launch, not the
        # kernel: the floor-adjusted number only where it means something.
        r["pct_of_sol_net"] = (
            round(min(100.0 * (r["sol_time_ms"] / 1e3) / net, 999.0), 1)
            if net > 1e-4
            else None
        )
    report = {
        "backend": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "hardware_model": peaks,
        "dispatch_floor_ms": round(floor_s * 1e3, 4),
        "cases": rows,
    }

    header = (
        f"{'case':34s} {'time ms':>9s} {'Gentry/s':>9s} {'GB/s':>8s} "
        f"{'SoL ms':>8s} {'bound':>6s} {'%SoL':>6s} {'net%':>6s}"
    )
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r['name']:34s} {r['time_ms']:9.3f} "
            f"{(r['entries_per_sec'] or 0) / 1e9:9.2f} "
            f"{r['achieved_gbytes_per_sec'] or 0:8.1f} "
            f"{r['sol_time_ms']:8.3f} {r['sol_bound']:>6s} "
            f"{r['pct_of_sol'] or 0:6.1f} "
            + (f"{r['pct_of_sol_net']:6.1f}" if r["pct_of_sol_net"] is not None else "     -")
        )
    print("\n".join(lines))

    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(report, indent=2))
        logger.info("kernel roofline report written to %s", out_path)
    return report


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="tpu3dm_torch kernel roofline benchmark")
    ap.add_argument("--quick", action="store_true", help="small shapes only")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run_kernel_benchmark(quick=args.quick, out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
