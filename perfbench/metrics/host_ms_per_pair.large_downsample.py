"""Host milliseconds a pair in the large path's ``large.downsample`` span (the
voxel grid of both clouds): its self time in the traced window over the
pairs registered (``large.pairs``), from the program's own records
(``lib/spans_large.py``)."""

from perfbench.lib import spans_large


def read(run):
    return spans_large.host_ms_per_pair("large.downsample")
