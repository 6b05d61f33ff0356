"""The program's own spans and counters, reduced to what the per-layer
metrics of the registration layer read.

``tpu3dm_torch.utils.profiler`` records, while a ``torch.profiler`` session
is open (the traced window), one record a span, ``(name, start_ns, end_ns,
parent, call_id, thread, index)`` on ``time.time_ns()``, with ``parent``
the ``index`` of the enclosing span on the same thread (-1 at the top), and
named host counters.  The reduction is here, from the raw records, so that
a change to the program cannot change the yardstick: a span's self time is
its duration less the union of its direct children's intervals, summed by
name.  A program that records no spans (one without ``Profiler.spans``)
gives None, as does a window in which nothing was recorded.
"""

from __future__ import annotations

from perfbench.lib.trace import union_length


def records() -> tuple[list, dict] | None:
    """(spans, counters) the program recorded, or None where it has no
    span API."""
    try:
        from tpu3dm_torch.utils.profiler import Profiler
    except ImportError:
        return None
    spans, counters = getattr(Profiler, "spans", None), getattr(Profiler, "counters", None)
    if spans is None or counters is None:
        return None
    return list(spans()), dict(counters())


def self_ns(spans: list) -> dict[str, int]:
    """Self time (ns) by span name, summed over the records."""
    kids: dict[int, list[tuple[int, int]]] = {}
    for _, start, end, parent, *_rest in spans:
        if parent >= 0:
            kids.setdefault(parent, []).append((start, end))
    out: dict[str, int] = {}
    for name, start, end, _parent, _call, _thread, index in spans:
        inner = [(max(a, start), min(b, end)) for a, b in kids.get(index, ())
                 if min(b, end) > max(a, start)]
        out[name] = out.get(name, 0) + (end - start) - int(union_length(inner))
    return out


def host_us_per_pair(name: str) -> float | None:
    """Self time of the spans named ``name`` (us) over the counter
    ``batch.pairs``, the pairs the recorded calls registered."""
    got = records()
    if got is None:
        return None
    spans, counters = got
    pairs = counters.get("batch.pairs", 0)
    if not spans or not pairs:
        return None
    return self_ns(spans).get(name, 0) * 1e-3 / pairs


def pad_pct() -> float | None:
    """100 x (1 - batch.rows_valid / batch.rows_padded)."""
    got = records()
    if got is None:
        return None
    _, counters = got
    padded = counters.get("batch.rows_padded", 0)
    if not counters.get("batch.pairs", 0) or not padded:
        return None
    return 100.0 * (1.0 - counters.get("batch.rows_valid", 0) / padded)
