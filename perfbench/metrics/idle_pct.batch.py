"""Device idle share (%) of the batch cells' traced window: 100 x (1 - the
union of device-op intervals, averaged over the cards, / the window's wall
time)."""


def read(run):
    return None if run.summary is None else run.summary.idle_pct
