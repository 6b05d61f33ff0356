"""Host microseconds a pair in the batch API's packing (``batch.pack``): valid
rows, capacities, buckets and bits before the first step, and each bucket's
padded copies and stacks: the self time of the traced window's
``batch.pack`` spans over the pairs its calls registered (``batch.pairs``),
from the program's own records (``lib/spans.py``)."""

from perfbench.lib import spans


def read(run):
    return spans.host_us_per_pair("batch.pack")
