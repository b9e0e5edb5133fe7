"""The device's idle share, in %, of the traced explains: 1 - the union of
its operations' intervals over the stretch's wall clock (device trace)."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.wall_s)
