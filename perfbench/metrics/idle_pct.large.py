"""Device idle share (%) of the large cell's traced window: 100 x (1 - the
union of device-op intervals / the window's wall time)."""


def read(run):
    return None if run.summary is None else run.summary.idle_pct
