"""Share (%) of its roofline that the block-sparse nearest-neighbour kernel
(csrc/nn_blocksparse.cu, ``blocksparse_kernel``) reaches in the traced
window: the least time of its launches (each a search of every block of a
pool cloud, ``lib/costs_large.py``, from the benchmark's own point count,
block and w) over the kernel's device time."""


def read(run):
    if run.summary is None:
        return None
    seconds, launches = run.summary.kernel_seconds("blocksparse_kernel")
    bound = launches * run.work.get("nn_blocksparse_launch_s", 0.0)
    if not launches or seconds <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / seconds
