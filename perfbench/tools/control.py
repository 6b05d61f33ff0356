#!/usr/bin/env python3
"""The control of a cell's correctness check, on the card:

    python3 perfbench/tools/control.py --workload <cell> --seeds 11,12,13

For each seed the cell's inputs are made as its runner makes them; then the
plain reference, one precision below the configuration's (float32 with
TF32 off, so TF32 on), is put in the program's place: its answers for the
pairs the check samples are judged by the cell's own numbers against the
reference at the configuration's precision.  One JSON line a seed: each
number, and the names of those whose limit the control fails.  A check that cannot
tell the control from the program fails no number here.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def control_numbers(run) -> tuple[dict, list]:
    """The cell's numbers for the control's answers: every gap
    (``lib.check.gap_numbers``) and the gate's miss share, and the checks
    of those the configuration gives a limit (``lib.check.Check``)."""
    from perfbench.lib import check, gate
    from perfbench.runners import batch

    cfg = run.config
    src, tgt, T_true = batch.make_pool(run)
    picks = check.sample(len(src), cfg["check_pairs"], run.seed)

    def answers(tf32):
        return batch.reference_answers(cfg, src, tgt, T_true, picks, run.device, tf32=tf32)

    mu, M2 = gate.moments(src[picks])
    refs, ctl = answers(False), answers(True)
    T_c = np.stack([t for t, _ in ctl])
    _, _, missed = gate.gate_misses(T_c, T_true[picks], mu, M2, cfg["gate"]["rotation_deg"],
                                    cfg["gate"]["alignment_rmse"])
    numbers = check.gap_numbers(T_c, [r for _, r in ctl], refs, mu, M2)
    gate_c = check.gate_check(missed, cfg["gate"])
    numbers[gate_c.name] = gate_c.value
    return numbers, [gate_c] + check.limited(numbers, cfg["limits"])


def control_checks(run) -> list:
    """The checks of the cell's numbers for the control's answers."""
    return control_numbers(run)[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()

    import torch

    from perfbench import run as bench
    from perfbench.lib import manifest

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    m = manifest.load(ROOT)
    cell = manifest.workload(m, args.workload)
    cfg = manifest.config(m, ROOT, cell["config"])
    traffic = manifest.traffic(ROOT / "perfbench", cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        r = bench.Run(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=0.0,
                      trace=False, devices=[torch.device("cuda", 0)],
                      bench_dir=ROOT / "perfbench")
        numbers, checks = control_numbers(r)
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "failed": [c.name for c in checks if not c.ok]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
