"""Host microseconds a pair in the fused step's ICP polish and frame unshift
(``fused.icp``): the self time of the traced window's ``fused.icp`` spans
over the pairs its calls registered (``batch.pairs``), from the program's
own records (``lib/spans.py``)."""

from perfbench.lib import spans


def read(run):
    return spans.host_us_per_pair("fused.icp")
