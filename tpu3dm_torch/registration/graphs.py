"""The port's CUDA graphs: one policy for every graph, and the batch API's
graphs of its fused step, kept across calls by bucket shape.

Two callers replay CUDA graphs: ``StepGraphs`` (below) keeps the batch
API's fused step as a graph for each bucket shape that recurs, and
``registration/icp.py:icp_loop`` captures an ICP iteration once a call and
replays it for the later iterations.  Both capture and replay through
their device's ``DeviceGraphs`` (``device_graphs``), which states the
policy once:

  - Memory: one memory pool and one capture stream a CUDA device.  Every
    graph of the device is captured into that pool on that stream; its
    static inputs, and whatever must outlive a replay, lie outside it.
    The state keeps the newest graph it captured, so the pool stays live
    while graphs come and go: PyTorch (2.11) takes no capture into a pool
    whose graphs are all gone, on the device and the host allocator
    alike, and a ``torch.cuda.MemPool`` keeps only the former.
  - Turns: a graph's intermediates may lie where another graph keeps its
    outputs, so one device's captures and replays take turns under its
    lock.  A replay first has the current stream wait on the card for the
    replay before it (an event, so whatever the host thread and stream),
    copies its inputs into the static ones, replays, clones its outputs
    out of the pool, and records the event.
  - Launch counts (``csrc.KERNELS``): a capture's kernel launches are
    tallied apart (``csrc.tallied_launches``) and added at each replay,
    where they run.

A replay runs the captured kernels in the same order on the same values,
so its answers are the eager code's, bit for bit.

``StepGraphs``: the batch API (``registration/batch.py``) runs one
``fused_register_step`` a capacity bucket.  The step launches its ~9,800
small device ops one by one from Python, whatever its lane count, so on
the card a call's host time sets its pace.  For each bucket shape

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
adaptive budget, whose extra chunks read the host).  A pending batch holds
the clones of its steps' outputs.

Spans and counters (``utils/profiler.py``, recorded only while recording is
on), the batch API's alone: ``batch.graph`` around a step's replay (the
copies in, the replay, the clones out); every step counts once into
``batch.graph_replays``, ``batch.graph_captures`` (a capture and its first
replay) or ``batch.eager_steps``.  A replay enters none of
``fused_register_step``'s spans, so ``fused.ransac``, ``fused.rescue`` and
``fused.icp`` record nothing for a replayed bucket: its host time is
``batch.graph``'s, with no split by stage.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import torch

from tpu3dm_torch.csrc import add_launch_counts, tallied_launches
from tpu3dm_torch.utils.profiler import Profiler

MAX_GRAPHS = 16  # step keys kept, seen once or captured


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


@dataclass
class Graph:
    """One captured graph: the static inputs it reads, the outputs it writes
    in the pool, and the kernel launches it holds."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    launches: dict[str, int]


class DeviceGraphs:
    """One CUDA device's graphs: their memory pool and capture stream, and the
    lock and event that make their captures and replays take turns (the
    module docstring)."""

    def __init__(self, index: int) -> None:
        self.device = torch.device("cuda", index)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.lock = threading.RLock()
        self.done = torch.cuda.Event()  # recorded after each replay's clones
        self._newest = None  # keeps the pool live

    def capture(self, fn: Callable, inputs: tuple) -> Graph:
        """``fn(*inputs)`` captured, ``inputs`` being the static tensors that
        its replays read; ``fn`` returns the tensors its replays write."""
        with self.lock:
            with tallied_launches() as launches:
                graph, outputs = capture_graph(fn, inputs, self.pool, self.stream)
            self._newest = graph
            return Graph(graph, inputs, outputs, launches)

    def replay(self, graph: Graph, inputs: tuple = ()) -> tuple:
        """``graph`` replayed on ``inputs`` copied into its static ones (none:
        it reads them as they are); its outputs, cloned out of the pool."""
        with self.lock:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(self.done)
            for static, x in zip(graph.inputs, inputs):
                static.copy_(x, non_blocking=True)
            graph.graph.replay()
            add_launch_counts(graph.launches)
            out = tuple(y.clone() for y in graph.outputs)
            self.done.record(current)
            return out


_DEVICES: dict[int, DeviceGraphs] = {}
_DEVICES_LOCK = threading.Lock()


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def device_graphs(dev: torch.device) -> DeviceGraphs | None:
    """The graphs of ``dev``, one state a CUDA device for the process; None
    off CUDA, where nothing is captured."""
    if dev.type != "cuda":
        return None
    index = _index(dev)
    with _DEVICES_LOCK:
        if index not in _DEVICES:
            _DEVICES[index] = DeviceGraphs(index)
        return _DEVICES[index]


class StepGraphs:
    """The ``MAX_GRAPHS`` least recently used step keys: each seen once
    (None) or captured (a ``Graph``)."""

    def __init__(self) -> None:
        self._keys: OrderedDict[tuple, Graph | None] = OrderedDict()
        self._lock = threading.Lock()  # guards _keys

    @staticmethod
    def key(dev: torch.device, knobs, inputs: tuple) -> tuple:
        return (_index(dev), knobs, tuple((tuple(x.shape), x.dtype) for x in inputs),
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
        device = device_graphs(dev)
        with device.lock:
            with self._lock:
                graph = self._keys.get(key)  # another thread may have captured it
            if graph is None:
                # Allocated on the capture stream, whose only other use is to
                # capture: memory a dropped graph's inputs free there goes to
                # a later graph's inputs, first written after the replays
                # before them.
                with torch.cuda.stream(device.stream):
                    static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device.stream.device)
                                   for x in inputs)
                graph = device.capture(step, static)
                Profiler.count("batch.graph_captures", 1)
            else:
                Profiler.count("batch.graph_replays", 1)
            with self._lock:
                self._put(key, graph)
            with Profiler("batch.graph"):
                return device.replay(graph, inputs)

    def _put(self, key: tuple, graph: Graph | None) -> None:
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
