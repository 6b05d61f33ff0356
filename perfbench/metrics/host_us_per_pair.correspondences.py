"""Host microseconds a pair in the fused step's inputs, frame shift and mutual
FPFH correspondences (``fused.correspondences``): the self time of the
traced window's ``fused.correspondences`` spans over the pairs its calls
registered (``batch.pairs``), from the program's own records
(``lib/spans.py``)."""

from perfbench.lib import spans


def read(run):
    return spans.host_us_per_pair("fused.correspondences")
