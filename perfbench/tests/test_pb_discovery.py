"""Discovery by name: a copy of the benchmark gains a configuration, a
traffic mix and a per-layer metric as new files plus new BENCHMARK.json
entries, and the harness runs the new cell with no existing file edited."""

import hashlib
import json
import shutil
from pathlib import Path

from perfbench import run as bench

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()}


def test_new_files_and_entries_run_with_no_file_edited(tmp_path, capsys):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = _digests(tmp_path)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((ROOT / "perfbench" / "configs" / "scan20k.json").read_text())
    cfg.update(name="arch3k", family="arch", points=3000, ransac_iterations=256,
               rescue_restarts=0, check_pairs=2)
    (tmp_path / "perfbench" / "configs" / "arch3k.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench" / "traffic" / "tinyloop.json").write_text(json.dumps(
        {"runner": "batch", "pool_pairs": 2, "seed_pairs": 1, "call_pairs": 2,
         "warm_calls": 0, "trace_seconds": 1, "pool_seed": 1}))
    (tmp_path / "perfbench" / "metrics" / "config_keys.tiny.py").write_text(
        "def read(run):\n    return float(len(run.config))\n")
    b["configs"].append({"name": "arch3k", "source": "a test", "file":
                         "perfbench/configs/arch3k.json", "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "arch3k.tiny", "config": "arch3k", "traffic": "tinyloop",
                           "chips": 1, "why": "a test"})
    next(m for m in b["end_to_end"] if m["name"] == "pairs_per_s")["workloads"].append(
        "arch3k.tiny")
    b["per_layer"].append({"name": "config_keys.tiny", "unit": "keys", "better": "higher",
                           "source": "program_counter", "layer": "test", "moves": "pairs_per_s",
                           "workloads": ["arch3k.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    rc = bench.main(["--workload", "arch3k.tiny", "--seed", "3", "--seconds", "0.01",
                     "--trace", "1"], require_cuda=False, root=tmp_path)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metrics"]["config_keys.tiny"]["value"] == float(len(cfg))
    assert list(out)[-1] == "checks"
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_gives_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", "scan20k.register", "--seed", "1", "--seconds", "1"])
    assert rc == 3
    assert capsys.readouterr().out.strip() == ""


def test_unknown_cell_gives_no_result(capsys):
    rc = bench.main(["--workload", "no.such.cell", "--seed", "1", "--seconds", "1"])
    assert rc == 2
    assert capsys.readouterr().out.strip() == ""
