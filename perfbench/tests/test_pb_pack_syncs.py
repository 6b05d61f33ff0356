"""The reader of ``pack_syncs_per_pair.batch``: planted counters give their
ratio; None without ``batch.pairs``, without the program's counter (a
program that does not count its packing's host reads), or without the span
API; the manifest's entry."""

from pathlib import Path

import pytest

from perfbench.lib import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NAME = "pack_syncs_per_pair.batch"


@pytest.fixture
def program():
    from tpu3dm_torch.utils.profiler import Profiler

    Profiler.enable(False)
    Profiler.reset()
    yield Profiler
    Profiler.enable(False)
    Profiler.reset()


def _plant(Profiler, counters):
    Profiler.enable()
    for name, n in counters.items():
        Profiler.count(name, n)
    Profiler.enable(False)


def _read():
    return manifest.metric_reader(BENCH, NAME).read(None)


@pytest.mark.parametrize("pairs, syncs", [(512, 1), (1024, 2), (3, 6)])
def test_reader_gives_host_reads_a_pair(program, pairs, syncs):
    _plant(program, {"batch.pairs": pairs, "batch.pack_syncs": syncs, "batch.rows_valid": 7})
    assert _read() == pytest.approx(syncs / pairs)


@pytest.mark.parametrize("state", ["no pairs", "no sync counter", "nothing recorded",
                                   "no span API"])
def test_reader_gives_none_with_nothing_to_read(program, monkeypatch, state):
    planted = {"no pairs": {"batch.pack_syncs": 2},
               "no sync counter": {"batch.pairs": 512, "batch.rows_padded": 1024},
               "nothing recorded": {},
               "no span API": {"batch.pairs": 512, "batch.pack_syncs": 1}}[state]
    _plant(program, planted)
    if state == "no span API":
        monkeypatch.delattr(program, "spans")
        monkeypatch.delattr(program, "counters")
    assert _read() is None


def test_manifest_entry():
    m = manifest.load(ROOT)
    assert manifest.validate(m, ROOT) == []
    (e,) = [x for x in m["per_layer"] if x["name"] == NAME]
    assert e == {"name": NAME, "unit": "syncs/pair", "better": "lower",
                 "source": "program_counter", "layer": "registration", "moves": "pairs_per_s",
                 "workloads": ["scan20k.register"]}
    assert m["per_layer"][-1] is e
