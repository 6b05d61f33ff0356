"""Share (%) of its roofline that the mutual FPFH search kernel
(csrc/lane_mutual.cu, ``lane_mutual_kernel``) reaches in the traced window:
the least time of the traced calls' searches (``lib/costs.py``, from the
benchmark's own valid-row counts) over the kernel's device time."""


def read(run):
    if run.summary is None:
        return None
    seconds, launches = run.summary.kernel_seconds("lane_mutual_kernel")
    bound = run.work.get("lane_mutual_bound_s", 0.0)
    if not launches or seconds <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / seconds
