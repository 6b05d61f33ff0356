"""Host microseconds a pair in the fused step's RANSAC (``fused.ransac``): the
bit checks and the rescue's restarts, or the single RANSAC and its fitness:
the self time of the traced window's ``fused.ransac`` spans over the pairs
its calls registered (``batch.pairs``), from the program's own records
(``lib/spans.py``)."""

from perfbench.lib import spans


def read(run):
    return spans.host_us_per_pair("fused.ransac")
