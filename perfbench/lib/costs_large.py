"""The work of the block-sparse nearest-neighbour search (kernel 6,
csrc/nn_blocksparse.cu) behind ``nn_blocksparse_roofline``, at the H100's
peaks of ``lib/costs.py``.

A launch searches ``query_blocks`` blocks of ``block`` query rows, each
over ``w`` target blocks of ``block`` rows: query_blocks x block x w x
block candidate entries, 7 fp32 instructions an entry (3 products, 2 adds,
the -2 scale and the comparison), as PERF.md's kernel table counts it.
Bytes: each query row read and its distance and index written once, the
target rows the launch can visit read once, and the table.  The sizes are
the benchmark's own (its clouds' point counts, the configuration's block
and w), never the program's internals.
"""

from __future__ import annotations

from perfbench.lib.costs import sol_time

FP32_PER_ENTRY = 7.0


def nn_blocksparse_seconds(query_blocks: int, w: int, block: int, target_rows: int) -> float:
    """Least time of one launch over ``query_blocks`` query blocks."""
    q_rows = float(query_blocks) * block
    entries = q_rows * w * block
    t_rows = min(float(target_rows), float(query_blocks) * w * block)
    n_bytes = 12.0 * (q_rows + t_rows) + 4.0 * query_blocks * w + 8.0 * q_rows
    return sol_time(n_bytes, fp32=FP32_PER_ENTRY * entries)[0]
