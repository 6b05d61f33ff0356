"""CUDA graphs of the batch API's fused step, kept across calls by bucket shape.

The batch API (``registration/batch.py``) runs one ``fused_register_step``
a capacity bucket.  The step launches its ~9,800 small device ops one by
one from Python, whatever its lane count, so on the card a call's host time
sets its pace.  ``StepGraphs`` keeps one CUDA graph of a whole step for each
bucket shape that recurs:

  - the first sighting of a key runs the step eagerly, as it always has
    (which also builds the kernels, sets their attributes and creates the
    library handles, none of which a capture may do),
  - the second captures the step on static copies of its inputs, then
    replays it,
  - every later sighting copies its inputs into the static ones and replays.

At the second sighting the capture takes the eager step's place: it traces
the step's Python as the eager step would, and adds the graph's
instantiation and one replay.  Every later sighting saves most of an eager
step's host time.  A shape seen once pays nothing.

The key is everything that fixes the captured work: the device, the step's
knobs, each input's shape and dtype (the lane count and the capacity among
them), and the float32 matmul precision (whether cuBLAS may take TF32),
which picks kernels at capture.  It holds no host thread: every thread sees
the same graphs, so a shape that a thread pool met (``serve``'s prewarm)
replays on the thread that serves.  At most ``MAX_GRAPHS`` keys are kept,
seen once or captured, and the least recently used is dropped first, which
bounds the graphs' memory.  The caller keeps the step eager where a replay
could not be exact (``batch._Knobs.step``: off CUDA, on a mesh, with the
adaptive budget, whose extra chunks read the host).

A replay runs the eager step's kernels in the same order on the same
values, so its answers are the eager step's, bit for bit.

Memory: the graphs of one device share one memory pool, apart from
``icp.py``'s; their static inputs lie outside it.  A graph's intermediates
may lie where another graph keeps its outputs, so one device's captures
and replays take turns under a lock, each replay first waits on the card
for the one before it (an event, so whatever the host thread and stream),
and its outputs are cloned out of the pool before the next can start; a
pending batch holds those clones.

Launch counts (``csrc.KERNELS``): a capture's launches are tallied apart
(``csrc.tallied_launches``) and added at each replay, where they run.

Spans and counters (``utils/profiler.py``, recorded only while recording is
on): ``batch.graph`` around a replay (the copies in, the replay, the clones
out); every step counts once into ``batch.graph_replays``,
``batch.graph_captures`` (a capture and its first replay) or
``batch.eager_steps``.  A replay enters none of ``fused_register_step``'s
spans, so ``fused.ransac``, ``fused.rescue`` and ``fused.icp`` record nothing
for a replayed bucket: its host time is ``batch.graph``'s, with no split by
stage.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import torch

from tpu3dm_torch.csrc import add_launch_counts, tallied_launches
from tpu3dm_torch.utils.profiler import Profiler

MAX_GRAPHS = 16  # keys kept, seen once or captured


def capture_graph(fn: Callable, args: tuple, pool, stream: torch.cuda.Stream) -> tuple:
    """(graph, outputs): ``fn(*args)`` on CUDA tensors captured as one CUDA
    graph into memory pool ``pool`` on the side stream ``stream``, which
    first waits for the current stream, as the current stream then waits
    for it.  The capture runs nothing: each replay writes ``outputs``."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    current.wait_stream(stream)
    return graph, out


class StepGraph:
    """One captured step: its graph, the static inputs it reads, the static
    outputs it writes and the kernel launches it holds."""

    def __init__(self, step: Callable, inputs: tuple, pool, stream: torch.cuda.Stream) -> None:
        # Allocated on the capture stream, whose only other use is to
        # capture: memory a dropped graph's inputs free there goes to a later
        # graph's inputs, first written after the replays before them.
        with torch.cuda.stream(stream):
            self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=stream.device)
                                for x in inputs)
        with tallied_launches() as self.launches:
            self.graph, self.outputs = capture_graph(step, self.inputs, pool, stream)

    def replay(self, inputs: tuple) -> tuple:
        """The step's outputs for ``inputs``, cloned out of the pool."""
        for static, x in zip(self.inputs, inputs):
            static.copy_(x, non_blocking=True)
        self.graph.replay()
        add_launch_counts(self.launches)
        return tuple(y.clone() for y in self.outputs)


class _Device:
    """One device's graphs: their memory pool and capture stream, and the
    lock and event that make their captures and replays take turns."""

    def __init__(self, index: int) -> None:
        self.device = torch.device("cuda", index)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()  # recorded after each replay's clones

    def capture(self, step: Callable, inputs: tuple) -> StepGraph:
        return StepGraph(step, inputs, self.pool, self.stream)

    def replay(self, graph: StepGraph, inputs: tuple) -> tuple:
        current = torch.cuda.current_stream(self.device)
        current.wait_event(self.done)
        out = graph.replay(inputs)
        self.done.record(current)
        return out


class StepGraphs:
    """The ``MAX_GRAPHS`` least recently used step keys: each seen once
    (None) or captured (a ``StepGraph``)."""

    def __init__(self) -> None:
        self._keys: OrderedDict[tuple, StepGraph | None] = OrderedDict()
        self._devices: dict[int, _Device] = {}
        self._lock = threading.Lock()  # guards _keys and _devices

    @staticmethod
    def key(dev: torch.device, knobs, inputs: tuple) -> tuple:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return (index, knobs, tuple((tuple(x.shape), x.dtype) for x in inputs),
                torch.get_float32_matmul_precision())

    def run(self, dev: torch.device, knobs, inputs: tuple, step: Callable) -> tuple:
        """``step(*inputs)`` (CUDA tensors on ``dev``; ``knobs``, hashable,
        fix the rest of its work): eager at a key's first sighting, captured
        and replayed at its second, replayed from then on."""
        key = self.key(dev, knobs, inputs)
        with self._lock:
            seen = key in self._keys
            self._put(key, self._keys.get(key))
        if not seen:
            Profiler.count("batch.eager_steps", 1)
            return step(*inputs)
        device = self._device(key[0])
        with device.lock:
            with self._lock:
                graph = self._keys.get(key)  # another thread may have captured it
            if graph is None:
                graph = device.capture(step, inputs)
                Profiler.count("batch.graph_captures", 1)
            else:
                Profiler.count("batch.graph_replays", 1)
            with self._lock:
                self._put(key, graph)
            with Profiler("batch.graph"):
                return device.replay(graph, inputs)

    def _device(self, index: int) -> _Device:
        with self._lock:
            if index not in self._devices:
                self._devices[index] = _Device(index)
            return self._devices[index]

    def _put(self, key: tuple, graph: StepGraph | None) -> None:
        """Under ``_lock``: ``key`` as the most recently used."""
        self._keys[key] = graph
        self._keys.move_to_end(key)
        while len(self._keys) > MAX_GRAPHS:
            self._keys.popitem(last=False)

    def __len__(self) -> int:
        return len(self._keys)

    def graphs(self) -> int:
        """The captured graphs held."""
        with self._lock:
            return sum(g is not None for g in self._keys.values())
