"""The control of the scan20k cells' check, on a card: the plain reference
one precision below the configuration's (TF32 on, where the configuration
states float32 with TF32 off), put in the program's place, fails one of the
cell's numbers (the RMSE gap at the 90th percentile), at a size a test
run holds (16 pairs of a 64-pair pool).  Skips without a card;
``tools/control.py`` runs it at the cell's own size."""

from pathlib import Path

import pytest

from perfbench import run as bench
from perfbench.lib import manifest
from perfbench.tools import control

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tf32_control_fails_a_number_of_the_register_cell(card, seed):
    m = manifest.load(ROOT)
    cell = manifest.workload(m, "scan20k.register")
    cfg = manifest.config(m, ROOT, cell["config"]) | {"check_pairs": 16}
    traffic = manifest.traffic(ROOT / "perfbench", cell["traffic"]) | {"pool_pairs": 64}
    run = bench.Run(cell=cell, config=cfg, traffic=traffic, seed=seed, seconds=0.0,
                    trace=False, devices=[card], bench_dir=ROOT / "perfbench")
    checks = control.control_checks(run)
    assert any(not c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]
