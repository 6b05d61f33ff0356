"""Host milliseconds a pair in the large path's ``large.coarse`` span (verified
two-mode RANSAC and the point-to-plane polish on the downsampled clouds):
its self time in the traced window over the pairs registered
(``large.pairs``), from the program's own records (``lib/spans_large.py``)."""

from perfbench.lib import spans_large


def read(run):
    return spans_large.host_ms_per_pair("large.coarse")
