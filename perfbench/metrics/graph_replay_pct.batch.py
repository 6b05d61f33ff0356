"""Share (%) of the traced window's bucket steps that replayed a CUDA graph:
100 x ``batch.graph_replays`` / (``batch.graph_replays`` +
``batch.graph_captures`` + ``batch.eager_steps``), the program's counters,
one a bucket step (``lib/spans.py``).  None where the program has no such
counters, or nothing was recorded."""

from perfbench.lib import spans

STEPS = ("batch.graph_replays", "batch.graph_captures", "batch.eager_steps")


def read(run):
    got = spans.records()
    if got is None:
        return None
    _, counters = got
    steps = sum(counters.get(name, 0) for name in STEPS)
    if not steps:
        return None
    return 100.0 * counters.get("batch.graph_replays", 0) / steps
