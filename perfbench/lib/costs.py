"""The yardstick of the roofline metrics: the H100's published peaks and the
work each kernel's inputs need.

``PEAKS`` and ``sol_time`` are frozen copies of the program's kernel-bench
model (NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit): a kernel's least time is the largest of its bytes over the memory
rate, its fp32 instructions over their rate and its tensor-core flops
over theirs.  The work functions count what the inputs need, from sizes the
benchmark computes itself (valid rows from its own voxel grid), never
from the program's internals.
"""

from __future__ import annotations

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "fp32_ops_per_s": 33.5e12,
    "bf16_tensor_flops": 989e12,
    "name": "NVIDIA H100 SXM (published dense peaks, 700 W)",
}


def sol_time(hbm_bytes: float, *, fp32: float = 0.0, tensor: float = 0.0) -> tuple[float, str]:
    """(seconds, bound): the larger of bytes over the memory rate, fp32
    instructions over their rate and tensor-core flops over theirs, and
    which one binds ("hbm", "fp32" or "tensor")."""
    times = {
        "hbm": hbm_bytes / PEAKS["hbm_bytes_per_s"],
        "fp32": fp32 / PEAKS["fp32_ops_per_s"],
        "tensor": tensor / PEAKS["bf16_tensor_flops"],
    }
    bound = max(times, key=times.get)
    return times[bound], bound


def lane_mutual_seconds(src_rows, tgt_rows) -> float:
    """Least time of the mutual FPFH search over lanes with ``src_rows[i]``
    x ``tgt_rows[i]`` valid rows at d = 33: 35 fp32 instructions a valid
    entry (33 FMAs, the norms' add, the -2 scale); bytes: each valid feature
    row (33 floats) read once, the masks, and each source row's index and
    flag written once."""
    entries = sum(float(a) * float(b) for a, b in zip(src_rows, tgt_rows))
    rows_a, rows_b = float(sum(src_rows)), float(sum(tgt_rows))
    n_bytes = 132.0 * (rows_a + rows_b) + (rows_a + rows_b) + 5.0 * rows_a
    return sol_time(n_bytes, fp32=35.0 * entries)[0]

