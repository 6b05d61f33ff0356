"""Device kernels, copies and sets the profiler listed in the traced window,
over the pairs the window's calls registered: the launch count a
full-resolution pair pays."""


def read(run):
    pairs = run.work.get("pairs_traced", 0)
    if run.summary is None or not pairs:
        return None
    return run.summary.n_device_ops / pairs
