"""Host microseconds a pair in ``PendingBatch.resolve`` (``batch.resolve``):
the wait for the device, the copies to the host and the fold into input
order: the self time of the traced window's ``batch.resolve`` spans over the
pairs its calls registered (``batch.pairs``), from the program's own records
(``lib/spans.py``)."""

from perfbench.lib import spans


def read(run):
    return spans.host_us_per_pair("batch.resolve")
