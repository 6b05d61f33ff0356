"""Host microseconds a pair in the batch API's graph replays
(``batch.graph``: the copies of a bucket's inputs in, the replay, the
clones of its outputs out): the self time of the traced window's
``batch.graph`` spans over the pairs its calls registered (``batch.pairs``),
from the program's own records (``lib/spans.py``).  None where the program
counts no bucket steps by kind (one without the graphs), or nothing was
recorded."""

from perfbench.lib import spans

STEPS = ("batch.graph_replays", "batch.graph_captures", "batch.eager_steps")


def read(run):
    got = spans.records()
    if got is None or not any(name in got[1] for name in STEPS):
        return None
    return spans.host_us_per_pair("batch.graph")
