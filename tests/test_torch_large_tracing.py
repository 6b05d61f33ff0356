"""The large path's spans and counters (``registration/large.py``): one
``large.register`` a call with the five stage spans directly inside it, in
order; the counters of the call; and nothing recorded while recording is
off.  CPU, a 6,000-point pair, on both routes."""

import numpy as np
import pytest
import torch

from perfbench.lib import synthetic
from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.registration import large
from tpu3dm_torch.utils.profiler import Profiler

STAGES = ["large.downsample", "large.features", "large.coarse", "large.partition",
          "large.fine"]


@pytest.fixture
def profiler():
    Profiler.enable(False)
    Profiler.reset()
    yield Profiler
    Profiler.enable(False)
    Profiler.reset()


def _pair(tensors: bool):
    src, tgt, _ = synthetic.arch_pairs(1, 6000, synthetic.generator(9, 0, "cpu"), sigma=0.002)
    src, tgt = src[0], tgt[0]
    return (src, tgt) if tensors else (src.numpy(), tgt.numpy())


def _register(src, tgt):
    return large.register_arrays_large(src, tgt, PipelineConfig.with_voxel_size(0.3),
                                       device="cpu", key=1, block=64, restarts=1)


@pytest.mark.parametrize("tensors", [True, False], ids=["device_route", "host_route"])
def test_large_spans_nest_as_listed(profiler, tensors):
    src, tgt = _pair(tensors)
    profiler.enable()
    fine, _ = _register(src, tgt)
    profiler.enable(False)
    spans = profiler.spans()
    top = [s for s in spans if s.name == "large.register"]
    assert len(top) == 1 and top[0].parent == -1 and top[0].call_id >= 0
    inner = sorted((s for s in spans if s.parent == top[0].index), key=lambda s: s.index)
    assert [s.name for s in inner] == STAGES
    assert all(top[0].start_ns <= s.start_ns <= s.end_ns <= top[0].end_ns for s in inner)
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))
    assert {s.call_id for s in inner} == {top[0].call_id}
    # The program's inner spans (the preprocessing's, the batch API's) nest
    # below the stages, never beside them.
    assert {s.name for s in spans if s.parent == -1} == {"large.register"}
    assert profiler.counters() == {
        "large.pairs": 1, "large.points": 12000, "large.blocks": -(-6000 // 64),
        "large.fine_iters": int(fine.iterations)}


def test_large_path_records_nothing_while_off(profiler):
    src, tgt = _pair(True)
    on, _ = _register(src, tgt)
    assert profiler.spans() == [] and profiler.counters() == {}
    profiler.enable()
    off, _ = _register(src, tgt)
    assert torch.equal(on.transformation, off.transformation)
    assert np.isclose(float(on.inlier_rmse), float(off.inlier_rmse), rtol=0, atol=0)
