"""Manifest validation: the committed BENCHMARK.json is sound, and each rule
catches its break."""

import copy
from pathlib import Path

import pytest

from perfbench.lib import manifest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def bench():
    return manifest.load(ROOT)


def test_committed_manifest_is_sound(bench):
    assert manifest.validate(bench, ROOT) == []


def test_every_cell_reports_setup_s_another_end_to_end_and_a_per_layer_metric(bench):
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(bench, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(bench, cell["name"], "per_layer")


def _broken(bench, edit):
    b = copy.deepcopy(bench)
    edit(b)
    return manifest.validate(b, ROOT)


@pytest.mark.parametrize("edit, words", [
    (lambda b: b["workloads"][0].update(name="bad name"), "bad name"),
    (lambda b: b["end_to_end"][0].update(unit="pairs per s"), "bad unit"),
    (lambda b: b["per_layer"][0].update(name="idle,pct"), "bad name"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "outside"),
    (lambda b: b["end_to_end"][0].update(source="program_span"), "host_clock or device_trace"),
    (lambda b: b.update(extra=1), "top-level keys"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="copy")), "repeat"),
    (lambda b: b["configs"][0].update(file="perfbench/configs/none.json"), "no file"),
])
def test_each_rule_catches_its_break(bench, edit, words):
    errs = _broken(bench, edit)
    assert any(words in e for e in errs), errs


def test_per_layer_metric_cells_must_report_its_moves_metric(bench):
    def edit(b):
        # The cell's end-to-end metrics lose pairs_per_s; its per-layer
        # metrics still move it.
        next(x for x in b["end_to_end"] if x["name"] == "pairs_per_s")["workloads"].clear()
    errs = _broken(bench, edit)
    assert any("does not report pairs_per_s" in e for e in errs), errs


def test_at_most_a_quarter_of_the_cells_take_four_chips(bench):
    def edit(b):
        # One cell on four chips is always allowed; two of three are not.
        b["workloads"] += [dict(b["workloads"][0], name=f"four{i}", traffic=f"four{i}", chips=4)
                           for i in range(2)]
    errs = _broken(bench, edit)
    assert any("4 chips" in e for e in errs), errs
