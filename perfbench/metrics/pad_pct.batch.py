"""Share (%) of the rows the traced window's buckets ran that were padding:
100 x (1 - ``batch.rows_valid`` / ``batch.rows_padded``), the program's
counters of each registered pair's valid source and target rows up to its
bucket's capacity, and of twice that capacity (``lib/spans.py``)."""

from perfbench.lib import spans


def read(run):
    return spans.pad_pct()
