#!/usr/bin/env python3
"""The control of the full-resolution cell's correctness check, on the card:

    python3 perfbench/tools/control_large.py --workload arch1m.large --seeds 11,12,13

For each seed the cell's pool is made as its runner makes it; then the
plain reference, one precision below the configuration's (float32 with
TF32 off, so TF32 on), is put in the program's place on ``check_pairs``
pool pairs drawn from the seed, and judged by the cell's own numbers
against the reference at the configuration's precision
(``runners/large.py:control_numbers``).  One JSON line a seed: each
number, and the names of those whose limit the control fails.

The gate's control, a planted election fault:

    python3 perfbench/tools/control_large.py --fault unverified_election --seeds 11,12

runs the cell for ``--seconds`` a seed with the verified restarts' election
cut to the candidate of highest RANSAC fitness (``unverified_election``:
the verification then only splits that fitness's ties) and prints each
run's result line, whose ``gate_miss_share`` shows how far the gate sees
the election (PERF.md section 2).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def unverified_election(setattr_) -> None:
    """Plant the election fault through ``setattr_(module, name, value)``
    (``monkeypatch.setattr`` or ``setattr``): only candidates at the highest
    RANSAC fitness are eligible, and no verified fitness overrides them."""
    from tpu3dm_torch.registration import large

    setattr_(large, "RESCUE_TIE_RATIO", 1.0)
    setattr_(large, "RESCUE_OVERRIDE_MARGIN", math.inf)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="arch1m.large")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=["unverified_election"])
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()

    import torch

    from perfbench import run as bench
    from perfbench.lib import manifest
    from perfbench.runners import large

    if not torch.cuda.is_available():
        print("control_large: no CUDA card", file=sys.stderr)
        return 3
    if args.fault:
        unverified_election(setattr)
        rcs = [bench.main(["--workload", args.workload, "--seed", s, "--seconds",
                           str(args.seconds), "--trace", "0"]) for s in args.seeds.split(",")]
        return max(rcs)
    m = manifest.load(ROOT)
    cell = manifest.workload(m, args.workload)
    cfg = manifest.config(m, ROOT, cell["config"])
    traffic = manifest.traffic(ROOT / "perfbench", cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = bench.Run(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=0.0,
                      trace=False, devices=[torch.device("cuda", 0)],
                      bench_dir=ROOT / "perfbench")
        numbers, checks = large.control_numbers(r)
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "failed": [c.name for c in checks if not c.ok],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
