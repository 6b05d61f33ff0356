"""Iterations of the full-resolution ICP a pair: the program's counter
``large.fine_iters`` over ``large.pairs``, in the traced window
(``lib/spans_large.py``)."""

from perfbench.lib import spans_large


def read(run):
    return spans_large.per_pair("large.fine_iters")
