#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tpu3dm_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<c>.json``) and a traffic mix
(``traffic/<t>.json``), whose ``runner`` (``runners/<d>.py``) makes the
inputs from the seed, sets up and warms the program, runs the measured
window, and judges the answers against the plain reference
(``reference/``).  The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and, with
``--trace 1``, ``breakdown``; its last key, ``checks``, holds each compared
number beside its limit, which also end standard error.

Exit codes: 0 a result was printed (correct or not); 2 bad arguments or a
broken manifest; 3 no CUDA card, or fewer than the cell asks for; 4 JAX or
the JAX package was loaded in this process.  There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Whole top-level module names that must never be loaded by a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3dm")


def process_age_s() -> float:
    """Seconds since this process started (/proc), so set-up counts the
    interpreter's start and every import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED_AT


_IMPORTED_AT = time.monotonic()


def fix_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build into tpu3dm_torch/csrc/build/)."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Run:
    """What a runner is given: the cell, its configuration and traffic, the
    seed, the window's length, the devices and the tracer."""

    def __init__(self, *, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, devices: list, bench_dir: Path) -> None:
        from perfbench.lib.trace import Tracer

        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.devices = devices
        self.device = devices[0]
        self.bench_dir = bench_dir
        self.tracer = Tracer(trace and devices[0].type == "cuda",
                             float(traffic.get("trace_seconds", seconds)), devices)


class LayerInputs:
    """What a per-layer metric's reader is given after the window."""

    def __init__(self, summary, counters: dict, work: dict, config: dict) -> None:
        self.summary, self.counters, self.work, self.config = summary, counters, work, config


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fmt_checks(checks) -> list[str]:
    return [f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
            for c in checks]


def main(argv=None, *, require_cuda: bool = True, device=None, root: Path = ROOT,
         config_overrides: dict | None = None, traffic_overrides: dict | None = None) -> int:
    """One run of one cell.  The keyword arguments serve the CPU tests: with
    ``require_cuda=False`` and ``device="cpu"`` the run skips the look for a
    card and drives the rest on the CPU, at the sizes the overrides set."""
    args = parse(argv)
    fix_cache_dirs()
    sys.path.insert(0, str(root))
    from perfbench.lib import manifest

    bench_dir = root / "perfbench"
    try:
        m = manifest.load(root)
        cell = manifest.workload(m, args.workload)
        config = manifest.config(m, root, cell["config"]) | (config_overrides or {})
        traffic = manifest.traffic(bench_dir, cell["traffic"]) | (traffic_overrides or {})
        drv_mod = manifest.runner(bench_dir, traffic["runner"])
    except (OSError, KeyError, ValueError) as e:
        print(f"perfbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    import torch

    chips = int(cell["chips"])
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {chips} CUDA card(s), this machine has {n}; "
                  "no result", file=sys.stderr)
            return 3
        devices = [torch.device("cuda", i) for i in range(chips)]
    else:
        devices = [torch.device(device or "cpu")] * chips

    run = Run(cell=cell, config=config, traffic=traffic, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), devices=devices, bench_dir=bench_dir)
    drv = drv_mod.Runner(run)
    try:
        drv.setup()
    except ImportError as e:  # a checkout without the program
        print(f"perfbench: the program under test does not import: {e}", file=sys.stderr)
        return 2
    setup_s = process_age_s()
    e2e = drv.window()
    e2e["setup_s"] = setup_s
    run.tracer.summarise()
    cuda = devices[0].type == "cuda"
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    drv.release()
    verdict = drv.check()

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4

    result = {
        "correct": verdict.correct,
        "attempted": verdict.attempted,
        "failed": verdict.failed,
    }
    summary = run.tracer.summary
    if args.trace:
        inputs = LayerInputs(summary, drv.counters(), drv.work(), config)
        metrics = {}
        for spec in manifest.metrics_of(m, cell["name"], "per_layer"):
            value = manifest.metric_reader(bench_dir, spec["name"]).read(inputs)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        metrics = {x["name"]: {"value": e2e[x["name"]], "unit": x["unit"]}
                   for x in manifest.metrics_of(m, cell["name"], "end_to_end")}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else devices[0].type,
        "kind": torch.cuda.get_device_name(devices[0]) if cuda else devices[0].type,
        "count": chips,
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if cuda else "not read",
    }
    if args.trace and summary is not None:
        result["device"]["busy_s"] = summary.busy_mean_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": summary.top_ops(10),
            "idle_gaps": [[name, s] for name, s in summary.idle_gaps],
        }
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in verdict.checks}
    for line in drv.notes():
        print(line, file=sys.stderr)
    if summary is not None:
        print(f"trace: {summary.window_s:.3f} s traced, device busy {summary.busy_mean_s:.4f} s "
              f"a card, {summary.n_device_ops} device ops, {summary.span_cover:.3f} of the "
              "device time inside harness spans", file=sys.stderr)
    for line in fmt_checks(verdict.checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)))
    return 0


def _finite(x):
    """``x`` with every non-finite float written as a string (strict JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
