"""The program's spans and counters of its full-resolution path
(``registration/large.py``: ``large.*``), reduced to what the per-layer
metrics of the large cell read, over the calls the traced window recorded
(the counter ``large.pairs``).  None where the program records no such
spans or counters (``lib/spans.py``)."""

from __future__ import annotations

from perfbench.lib import spans


def _recorded() -> tuple[list, dict, int] | None:
    got = spans.records()
    if got is None:
        return None
    recs, counters = got
    pairs = counters.get("large.pairs", 0)
    return (recs, counters, pairs) if pairs else None


def host_ms_per_pair(name: str) -> float | None:
    """Self time (ms) of the spans named ``name`` over ``large.pairs``."""
    got = _recorded()
    if got is None:
        return None
    recs, _, pairs = got
    if not any(r[0] == name for r in recs):
        return None
    return spans.self_ns(recs)[name] * 1e-6 / pairs


def per_pair(counter: str) -> float | None:
    """The counter ``counter`` over ``large.pairs``."""
    got = _recorded()
    if got is None or counter not in got[1]:
        return None
    return got[1][counter] / got[2]
