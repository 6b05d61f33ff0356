"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size (an arch pair family, which registers cleanly
there), with the program's entry point wrapped to plant one fault where
its answer is produced: every pose left where it started (the state
unchanged), half of each call's pairs left out (the rest's answers copied
over them), one answer altered, the reported RMSEs altered.  The same run
without the fault is correct."""

import json

import numpy as np
import pytest

from perfbench import run as bench

SMALL = {"family": "arch", "points": 3000, "ransac_iterations": 1024, "rescue_restarts": 0,
         "check_pairs": 4}
BATCH = {"pool_pairs": 4, "seed_pairs": 2, "call_pairs": 4, "warm_calls": 0}


def _run(capsys, cell, seconds, cfg, tr):
    rc = bench.main(["--workload", cell, "--seed", "123456789012345", "--seconds", str(seconds)],
                    require_cuda=False, config_overrides=cfg, traffic_overrides=tr)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _wrap_batch(monkeypatch, fault):
    from tpu3dm_torch.registration import batch

    real = batch.register_pairs_batched

    def broken(pairs, config=None, **kw):
        res = real(pairs, config, **kw)
        fault(res)
        return res

    monkeypatch.setattr(batch, "register_pairs_batched", broken)


def _unchanged(res):
    res.transforms[:] = np.eye(4, dtype=np.float32)


def _half(res):
    h = len(res.transforms) // 2
    res.transforms[h:] = res.transforms[:len(res.transforms) - h]
    res.icp_rmse[h:] = res.icp_rmse[:len(res.icp_rmse) - h]


def _altered(res):
    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    R = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    res.transforms[0] = R @ res.transforms[0]


def _rmse_altered(res):
    res.icp_rmse[:] = res.icp_rmse * 3.0


def _unanswered(res):
    res.transforms[0] = np.nan


def test_sound_batch_run_is_correct(capsys):
    out = _run(capsys, "scan20k.register", 0.01, SMALL, BATCH)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, _rmse_altered],
                         ids=["unchanged", "half_left_out", "answer_altered", "rmse_altered"])
def test_batch_fault_is_not_correct(capsys, monkeypatch, fault):
    _wrap_batch(monkeypatch, fault)
    out = _run(capsys, "scan20k.register", 0.01, SMALL, BATCH)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault,failed", [(None, 0), (_altered, 0), (_unanswered, 1)],
                         ids=["sound", "answer_altered", "unanswered"])
def test_batch_failed_counts_only_pairs_with_no_answer(capsys, monkeypatch, fault, failed):
    """A pair with no finite answer counts under ``failed`` (and fails
    ``correct``); one that answers wrongly is for ``correct`` alone."""
    if fault is not None:
        _wrap_batch(monkeypatch, fault)
    out = _run(capsys, "scan20k.register", 0.01, SMALL, BATCH)
    assert out["attempted"] == 4
    assert out["failed"] == failed
    assert out["correct"] == (fault is None), out["checks"]
