"""Host reads a pair in the batch API's packing: the program's counter
``batch.pack_syncs`` (each time the packing reads tensor values to the
host, the one read of a call's valid-row counts among them) over the pairs
the traced window's calls registered (``batch.pairs``), from the program's
own records (``lib/spans.py``).  None where the program has no such
counter, or nothing was recorded."""

from perfbench.lib import spans


def read(run):
    got = spans.records()
    if got is None:
        return None
    _, counters = got
    pairs = counters.get("batch.pairs", 0)
    if not pairs or "batch.pack_syncs" not in counters:
        return None
    return counters["batch.pack_syncs"] / pairs
